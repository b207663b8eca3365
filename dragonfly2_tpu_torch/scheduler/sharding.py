"""Sharded scheduler fleet (DESIGN.md §24).

The serving path is columnar and lock-free per instance (§18) but a
single scheduler still walls at one process.  The reference runs
scheduler *clusters* with manager-driven dynconfig assignment
(scheduler_cluster records; pkg/balancer's consistent-hash picker) —
this module is the horizontal story on top of it:

- ``ShardRing`` — consistent-hash ring over scheduler instances (virtual
  nodes, **deterministic** sha-based hashing so every process computes
  the same ownership — ``hash()`` randomization would split the fleet's
  brain), with a bounded-load ``pick`` (Mirrokni et al.: walk successors
  past members above ``load_factor × mean`` so one hot shard spills to
  its ring neighbors instead of melting).
- ``ShardDirectory`` — the manager-side durable membership record: the
  ACTIVE scheduler set, versioned, persisted through the (replicated)
  StateBackend namespace ``shard_membership`` (DF014-checked: writes
  under ``_mu``, recovery loader in the constructor).  A membership
  change bumps ``version``; the manager publishes the ring payload with
  the cluster dynconfig, so every client converges on the same ring.
- ``ShardGuard`` — scheduler-side ownership enforcement: task-scoped
  calls for tasks this shard does not own answer a REDIRECT-style
  steering error (``WrongShardError`` carries the owner and ring
  version); a ring-version bump triggers ``handoff()`` — the affected
  tasks are marked, their peers steered to the new owner on their next
  call, the move recorded under the ``scheduler/shard.handoff`` span
  (DF016-inventoried; the chaos drill renders it on the critical path).
- ``AdmissionController`` — per-shard load shedding fed by the §23
  sketch signals (windowed announce p99 vs budget + in-flight cap):
  lowest-priority work sheds first, refusals carry Retry-After like
  §20's standby 503 discipline.

Lock ordering: ``ShardGuard._mu`` and ``AdmissionController._mu`` are
leaf locks (no calls out while held); ``ShardDirectory._mu`` guards its
table writes only.

Port of ``dragonfly2_tpu/scheduler/sharding.py``, verbatim: ``shard_hash``, ``ShardRing``, ``ShardDirectory``,
``handoff_span``, the two steering exceptions, ``AdmissionController``
and ``ShardGuard``.  The wire maps the exceptions to HTTP 421 and 503 +
Retry-After (``rpc/scheduler_server.py``) and the client raises them
back (``rpc/scheduler_client.py``).  ``ShardRing.from_payload`` of
either package's ``to_payload`` places every key on the same member.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # lock-graph resolver type (§16): _table nests under _mu
    from ..manager.state import StateBackend

from ..utils import faultinject
from ..utils.metrics import Sketch
from ..utils.tracing import default_tracer
from ..utils.types import Priority
from . import metrics

DEFAULT_REPLICAS = 100  # virtual nodes per shard
DEFAULT_LOAD_FACTOR = 1.25  # bounded-load spill threshold (× mean load)


def shard_hash(key: str) -> int:
    """Deterministic 64-bit ring position.  sha1 (not ``hash()``): the
    daemon, every shard, and the manager must all place a task id at the
    SAME point of the ring across processes and interpreter restarts —
    PYTHONHASHSEED randomization would shear routing from ownership."""
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class ShardRing:
    """Consistent-hash ring over ``{shard_id: url}`` members.

    ``owner`` is the plain consistent-hash successor (the minimal-
    movement mapping the property tests pin); ``pick`` adds the
    bounded-load walk.  Instances are cheap value objects — routers and
    guards swap in a freshly built ring on every version bump rather
    than mutating a shared one under readers.
    """

    def __init__(
        self,
        members: Optional[Dict[str, str]] = None,
        *,
        replicas: int = DEFAULT_REPLICAS,
        version: int = 0,
    ) -> None:
        self.replicas = replicas
        self.version = version
        self._members: Dict[str, str] = {}
        self._ring: List[int] = []
        self._owners: Dict[int, str] = {}
        for sid, url in (members or {}).items():
            self.add(sid, url)

    # -- membership ----------------------------------------------------------

    def add(self, shard_id: str, url: str = "") -> None:
        if shard_id in self._members:
            self._members[shard_id] = url or self._members[shard_id]
            return
        self._members[shard_id] = url
        for i in range(self.replicas):
            h = shard_hash(f"{shard_id}#{i}")
            bisect.insort(self._ring, h)
            self._owners[h] = shard_id

    def remove(self, shard_id: str) -> None:
        if shard_id not in self._members:
            return
        del self._members[shard_id]
        for i in range(self.replicas):
            h = shard_hash(f"{shard_id}#{i}")
            idx = bisect.bisect_left(self._ring, h)
            if idx < len(self._ring) and self._ring[idx] == h:
                self._ring.pop(idx)
            self._owners.pop(h, None)

    def members(self) -> Dict[str, str]:
        return dict(self._members)

    def url_of(self, shard_id: str) -> Optional[str]:
        return self._members.get(shard_id)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, shard_id: str) -> bool:
        return shard_id in self._members

    # -- placement -----------------------------------------------------------

    def _successors(self, key: str) -> Iterable[str]:
        """Distinct members in ring order starting at the key's point."""
        if not self._ring:
            return
        start = bisect.bisect_right(self._ring, shard_hash(key))
        seen: set = set()
        n = len(self._ring)
        for off in range(n):
            sid = self._owners[self._ring[(start + off) % n]]
            if sid not in seen:
                seen.add(sid)
                yield sid

    def owner(self, key: str) -> Optional[str]:
        """The plain consistent-hash owner (None on an empty ring)."""
        for sid in self._successors(key):
            return sid
        return None

    def pick(
        self,
        key: str,
        *,
        load_of: Optional[Callable[[str], float]] = None,
        load_factor: float = DEFAULT_LOAD_FACTOR,
    ) -> Optional[str]:
        """Bounded-load placement: the owner unless it is above
        ``load_factor × mean`` of the fleet, in which case the walk
        spills to the first ring successor under the bound (falling back
        to the owner when everyone is hot — shedding, not routing, is
        the overload answer then)."""
        if load_of is None or len(self._members) <= 1:
            return self.owner(key)
        loads = {sid: max(0.0, float(load_of(sid))) for sid in self._members}
        bound = load_factor * (sum(loads.values()) / len(loads)) if loads else 0.0
        first = None
        for sid in self._successors(key):
            if first is None:
                first = sid
            if bound <= 0.0 or loads.get(sid, 0.0) <= bound:
                return sid
        return first

    # -- wire form (dynconfig payload) ---------------------------------------

    def to_payload(self) -> Dict[str, object]:
        return {
            "version": self.version,
            "replicas": self.replicas,
            "members": [
                {"id": sid, "url": url}
                for sid, url in sorted(self._members.items())
            ],
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, object]) -> "ShardRing":
        members = {
            str(m["id"]): str(m.get("url", ""))
            for m in payload.get("members", [])
            if isinstance(m, dict) and m.get("id")
        }
        return cls(
            members,
            replicas=int(payload.get("replicas", DEFAULT_REPLICAS)),
            version=int(payload.get("version", 0)),
        )


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


def handoff_span(
    task_id: str, *, from_shard: str = "", to_shard: str = "",
    ring_version: int = 0,
):
    """Client-side half of the cross-shard migration edge: wraps a
    task's re-announce/re-register on its new owner, so the flight
    recorder renders the handoff on the download's critical path (the
    guard's membership sweep opens the same span server-side)."""
    return default_tracer.span(
        "scheduler/shard.handoff",
        task_id=task_id,
        from_shard=from_shard,
        to_shard=to_shard,
        ring_version=ring_version,
    )


# -- steering / shedding wire errors -----------------------------------------


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


class AdmissionController:
    """Per-shard admission control + load shedding (§23 burn signals).

    Two saturation signals, both cheap enough for the announce path:

    - **in-flight bound** — concurrent admitted requests vs ``max_inflight``
      (the queue-depth proxy; rises instantly when arrival outruns
      service);
    - **latency burn** — the windowed announce p99 from a private §23
      mergeable sketch vs ``p99_budget_s`` (the SLO-shaped signal: burn
      ``= p99 / budget``; >1 means the latency budget is being eaten).

    Shedding is priority-banded, lowest class first: overload fraction
    ``f`` in (0, 1] sheds priorities ``>= ceil((1 - f) * LEVEL6)`` — at
    f=0.15 only LEVEL6 background work sheds; at f=1 everything but
    LEVEL0 does.  LEVEL0 (interactive) is never shed by the band (it
    only fails when the in-flight bound is exceeded at 2× — the hard
    wall protecting the process itself).

    Tenant QoS (DESIGN.md §26), with a ``TenantAccounting`` attached:

    - every request is accounted per tenant; a tenant past its declared
      ``announce_qps`` cap (possibly autopilot-tightened) is refused
      outright;
    - a tenant's declared priority class FLOORS its requests' priority
      (a "background" tenant cannot claim LEVEL0);
    - under overload the shed floor scales by the tenant's
      ``noise_factor`` — the over-quota tenant's lowest bands shed
      FIRST, a within-quota tenant keeps its bands until overload
      deepens;
    - the SLO autopilot's ``shed_bias`` adds straight into the overload
      fraction, tightening the floor fleet-wide while a declared SLO
      burns (qos/autopilot.py).
    """

    def __init__(
        self,
        *,
        max_inflight: int = 512,
        p99_budget_s: float = 0.050,
        window_s: float = 5.0,
        retry_after_s: float = 1.0,
        accounting=None,
    ) -> None:
        self._mu = threading.Lock()
        self.max_inflight = max_inflight
        self.p99_budget_s = p99_budget_s
        self.window_s = window_s
        self.retry_after_s = retry_after_s
        # qos.accounting.TenantAccounting — the ONE object behind the
        # announce path's per-tenant costs; None = tenant-blind admission
        # (the pre-§26 behavior).
        self.accounting = accounting
        # Autopilot output: added into overload() while a declared SLO
        # burns; 0.0 on the steady state.
        self._shed_bias = 0.0
        self._inflight = 0
        # Private sketches (NOT the registry-global ANNOUNCE_SECONDS):
        # with N in-process shards (sim/bench) the default registry is
        # shared, and a per-shard shed decision fed by fleet-wide
        # latency would shed the wrong shard.  Two-epoch rotation makes
        # the cumulative sketch a WINDOWED signal — a recovered shard
        # sheds from its current epoch, not last hour's burst.  The
        # unregistered construction is deliberate: epochs are created
        # and dropped per window, never exposed as a registry series.
        self._cur = Sketch(  # dflint: disable=DF017 — private epoch
            "scheduler_shard_admission_seconds", ""
        )
        self._prev: Optional[Sketch] = None
        self._epoch_started = time.monotonic()

    # -- signal --------------------------------------------------------------

    def observe(self, seconds: float) -> None:
        now = time.monotonic()
        with self._mu:
            if now - self._epoch_started >= self.window_s:
                self._prev = self._cur
                self._cur = Sketch(  # dflint: disable=DF017 — private epoch
                    "scheduler_shard_admission_seconds", ""
                )
                self._epoch_started = now
            cur = self._cur
        cur.observe(seconds)

    def inflight(self) -> int:
        with self._mu:
            return self._inflight

    def _windowed_p99(self) -> Optional[float]:
        with self._mu:
            cur, prev = self._cur, self._prev
        p99 = cur.quantile(0.99)
        if p99 is None and prev is not None:
            p99 = prev.quantile(0.99)
        return p99

    def set_shed_bias(self, bias: float) -> None:
        """Autopilot input: raises the effective overload fraction (the
        shed floor tightens) while a declared SLO burns; 0 restores the
        measured signals alone."""
        with self._mu:
            self._shed_bias = max(0.0, min(1.0, float(bias)))

    def shed_bias(self) -> float:
        with self._mu:
            return self._shed_bias

    def overload(self) -> float:
        """Saturation fraction in [0, 1]: max of the two burn signals
        plus the autopilot's shed bias, 0 while inside budget with no
        SLO burning."""
        with self._mu:
            inflight = self._inflight
            bias = self._shed_bias
        q_burn = inflight / self.max_inflight if self.max_inflight else 0.0
        p99 = self._windowed_p99()
        l_burn = (p99 / self.p99_budget_s) if p99 else 0.0
        # Inside-budget readings are 0 overload; past budget the excess
        # maps linearly into (0, 1] (2× budget == fully overloaded).
        # The autopilot's bias ADDS to the normalized fraction — a
        # burning fleet SLO tightens the floor even while this shard's
        # own signals read healthy (the declared SLO may measure an
        # end-to-end latency the admission sketch cannot see).
        base = max(0.0, min(1.0, max(q_burn, l_burn) - 1.0))
        return min(1.0, base + bias)

    # -- decision ------------------------------------------------------------

    def admit(
        self, priority: Priority = Priority.LEVEL0, *, tenant: str = ""
    ) -> None:
        """Raise ``ShardSaturatedError`` when this request's priority
        class is in the current shed band (lowest classes first; the
        over-quota tenant's bands first among tenants)."""
        accounting = self.accounting
        noise = 1.0
        if accounting is not None:
            qos = accounting.policy.for_tenant(tenant)
            # The tenant's declared class floors the request's priority:
            # a background tenant cannot claim LEVEL0 interactivity.
            priority = Priority(max(int(priority), int(qos.priority)))
            if not accounting.note(tenant):
                # Announce-rate cap (declared, or autopilot-tightened
                # for over-quota tenants): refused outright, before any
                # per-request work — the whole point of the cap.
                faultinject.fire("scheduler.qos.shed")
                from ..qos.metrics import QOS_RATE_CAPPED_TOTAL

                accounting.record_shed(tenant)
                QOS_RATE_CAPPED_TOTAL.inc(
                    tenant_class=accounting.class_of(tenant)
                )
                raise ShardSaturatedError(
                    retry_after_s=self.retry_after_s,
                    reason="tenant announce-rate cap",
                )
            noise = accounting.noise_factor(tenant)
        over = self.overload()
        with self._mu:
            hard_wall = self._inflight >= 2 * self.max_inflight
        if hard_wall:
            metrics.SHARD_SHED_TOTAL.inc(priority=f"level{int(priority)}")
            raise ShardSaturatedError(
                retry_after_s=self.retry_after_s,
                reason=f"in-flight {self._inflight} >= 2x bound",
            )
        if over <= 0.0 or priority is Priority.LEVEL0:
            return
        # The noisy tenant's floor drops fastest: at the same overload a
        # 3×-over-quota tenant sheds bands three times deeper than a
        # within-quota one (noise ∈ [1, 3], qos/accounting.py).
        shed_floor = (1.0 - min(1.0, over * noise)) * int(Priority.LEVEL6)
        if int(priority) >= shed_floor:
            faultinject.fire("scheduler.qos.shed")
            metrics.SHARD_SHED_TOTAL.inc(priority=f"level{int(priority)}")
            if accounting is not None:
                from ..qos.metrics import QOS_SHED_TOTAL

                accounting.record_shed(tenant)
                QOS_SHED_TOTAL.inc(
                    tenant_class=accounting.class_of(tenant),
                    priority=f"level{int(priority)}",
                )
            raise ShardSaturatedError(
                retry_after_s=self.retry_after_s * (1.0 + over),
                reason=(
                    f"overload {over:.2f}: shedding priority >= "
                    f"{shed_floor:.1f}"
                ),
            )

    def track(self):
        """Context manager for an admitted request: in-flight accounting
        + latency observation into the shed signal."""
        return _AdmissionTrack(self)


class _AdmissionTrack:
    def __init__(self, ctl: AdmissionController) -> None:
        self._ctl = ctl
        self._t0 = 0.0

    def __enter__(self) -> "_AdmissionTrack":
        with self._ctl._mu:
            self._ctl._inflight += 1
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._ctl.observe(time.monotonic() - self._t0)
        with self._ctl._mu:
            self._ctl._inflight -= 1


class ShardGuard:
    """Scheduler-side shard ownership: ring adoption, REDIRECT steering,
    and the membership-change handoff sweep.

    Attached to a ``SchedulerService`` (``service.shard_guard``); the
    service consults it at the task-scoped entry points.  Ring updates
    arrive through ``on_config`` (a dynconfig observer — the manager
    publishes the ring with the cluster config) or ``update_ring``
    (in-process fleets).
    """

    def __init__(
        self,
        shard_id: str,
        *,
        admission: Optional[AdmissionController] = None,
    ) -> None:
        self.shard_id = shard_id
        self.admission = admission
        self._mu = threading.Lock()
        self._ring: Optional[ShardRing] = None
        # Tasks this shard owned before a ring bump moved them: their
        # peers get steered (REDIRECT) on their next call instead of
        # silently double-serving a split-brain swarm.
        self._handed_off: Dict[str, str] = {}  # task_id -> new owner id
        # resource is attached by the service so handoff() can sweep the
        # live task table without a circular constructor.
        self.resource = None

    # -- ring adoption -------------------------------------------------------

    def on_config(self, config: Dict[str, object]) -> None:
        """Dynconfig observer: adopt ``scheduler_ring`` payloads.  Skips
        malformed/stale payloads (an observer exception would take down
        the dynconfig refresh for every other observer)."""
        payload = config.get("scheduler_ring")
        if not isinstance(payload, dict) or not payload.get("members"):
            return
        try:
            self.update_ring(ShardRing.from_payload(payload))
        except (KeyError, TypeError, ValueError):
            return

    def ring(self) -> Optional[ShardRing]:
        with self._mu:
            return self._ring

    def ring_version(self) -> int:
        with self._mu:
            return self._ring.version if self._ring is not None else 0

    def update_ring(self, ring: ShardRing) -> List[str]:
        """Adopt a new ring; on a version advance run the handoff sweep.
        Returns the task ids handed off (empty when none moved)."""
        with self._mu:
            current = self._ring
            if current is not None and ring.version <= current.version:
                return []
            self._ring = ring
        metrics.SHARD_RING_VERSION.set(ring.version, cluster="local")
        return self.handoff(ring)

    # -- handoff (membership change) -----------------------------------------

    def handoff(self, ring: ShardRing) -> List[str]:
        """Sweep the live task table for tasks this shard no longer owns
        under the new ring; mark them for REDIRECT steering.  The sweep
        is the cross-shard migration edge the flight recorder must show:
        it runs under the ``scheduler/shard.handoff`` span.
        """
        resource = self.resource
        if resource is None or len(ring) == 0:
            return []
        # Chaos seam: a handoff that dies mid-sweep must leave only
        # steerable state behind (marks are per-task, idempotent).
        faultinject.fire("shard.handoff")
        moved: List[str] = []
        with default_tracer.span(
            "scheduler/shard.handoff",
            shard=self.shard_id,
            ring_version=ring.version,
        ) as span:
            for task in resource.task_manager.items():
                owner = ring.owner(task.id)
                if owner is not None and owner != self.shard_id:
                    moved.append(task.id)
            with self._mu:
                # REBUILT each sweep (never merged): tasks the newest
                # ring returns to this shard unmark, and marks for tasks
                # long since GC'd don't accumulate forever.
                self._handed_off = {
                    tid: ring.owner(tid) or "" for tid in moved
                }
            span.attributes["tasks_moved"] = len(moved)
        if moved:
            metrics.SHARD_HANDOFFS_TOTAL.inc(amount=len(moved))
        return moved

    # -- steering ------------------------------------------------------------

    def check_task(self, task_id: str) -> None:
        """Raise the REDIRECT steering answer when ``task_id`` is owned
        elsewhere (by ring position, or because a handoff moved it)."""
        with self._mu:
            ring = self._ring
            new_owner = self._handed_off.get(task_id)
        if ring is None or len(ring) == 0:
            return
        owner = new_owner or ring.owner(task_id)
        if owner is None or owner == self.shard_id:
            return
        metrics.SHARD_REDIRECTS_TOTAL.inc()
        raise WrongShardError(
            task_id,
            owner_id=owner,
            owner_url=ring.url_of(owner) or "",
            ring_version=ring.version,
        )

    def admit(
        self, priority: Priority = Priority.LEVEL0, *, tenant: str = ""
    ) -> None:
        if self.admission is not None:
            self.admission.admit(priority, tenant=tenant)

    def track(self):
        if self.admission is not None:
            return self.admission.track()
        return _NullTrack()


class _NullTrack:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None
