"""Columnar million-peer swarm population + sharded fleet driver.

``sim/swarm.py`` drives the real scheduler stack peer-by-peer: one
``Peer`` object, one FSM walk, one Python call per piece — honest, and
walled around 1k hosts.  This module rebuilds the peer *population* on
the §18 columnar technique so ONE process can replay 100k–1M peers
against N real ``SchedulerService`` shards (DESIGN.md §24):

- ``ColumnarPopulation`` — synthetic peer state lives in preallocated
  slot columns (state, idc class, latent capacities/loads), and every
  discrete-event tick draws the join/leave/fail/announce event sets as
  vectorized bernoulli masks per idc churn class.  No per-peer Python
  runs until an event actually targets a peer.
- ``ShardedFleet`` — N in-process scheduler shards (each a REAL
  ``SchedulerService`` with its own Resource + columnar host store +
  ``ShardGuard``) behind one ``ShardRing``.  Task-scoped traffic routes
  by ring ownership; host announces pin to the host id's ring owner
  (task registration carries announce-time stats, so task owners never
  need a fan-out).  ``kill()`` removes a member, bumps the ring and
  runs every survivor's handoff sweep — the membership-change protocol
  the chaos drill exercises over the wire.
- ``FleetSwarmDriver`` — applies each tick's event arrays to the fleet
  through the real entry points: ``announce_host`` for joins and
  re-announces, ``register_peer`` → batched ``report_pieces_finished``
  → ``report_peer_finished`` for the download slice, steering
  (``WrongShardError``) followed like a client would.

The measured product (``bench/fleet_swarm.py``) is **aggregate
announces/sec across shards** — the fleet-scale serving signal the
ROADMAP asks for.

Port of ``dragonfly2_tpu/sim/fleet.py``, verbatim.  It imports numpy
and the scheduler package only: the shards run the rule ``Evaluator`` on
their columnar host stores, whose live path is numpy in both packages.  With the same
``FleetConfig`` its ``deterministic_summary`` equals the reference's.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..records.synthetic import IDC_NAMES, PIECE_SIZE, REGIONS
from ..scheduler import (
    AdmissionController,
    Evaluator,
    HostFeatureCache,
    Resource,
    ScheduleResultKind,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
    ShardGuard,
    ShardRing,
    ShardSaturatedError,
    WrongShardError,
)
from ..scheduler.resource import Host
from ..utils import idgen
from ..utils.types import HostType

# -- churn classes ------------------------------------------------------------

# (name, population share, join/tick, leave/tick, fail/tick): stable
# datacenter cores, churny edge boxes, and mobile-grade peers that
# appear and vanish.  Rates are per ONLINE (leave/fail) or OFFLINE
# (join) peer per tick.
IDC_CLASSES: Tuple[Tuple[str, float, float, float, float], ...] = (
    ("core",   0.50, 0.60, 0.002, 0.0005),
    ("edge",   0.30, 0.30, 0.020, 0.005),
    ("mobile", 0.20, 0.15, 0.080, 0.020),
)

_OFFLINE = np.uint8(0)
_ONLINE = np.uint8(1)


@dataclass
class FleetConfig:
    num_peers: int = 100_000
    seed: int = 0
    # Fraction of ONLINE peers that re-announce each tick (the keepalive
    # cadence scaled to tick time).
    announce_rate: float = 0.5
    # Fraction of ONLINE peers that start a download each tick.
    download_rate: float = 0.002
    pieces_per_download: int = 4
    task_catalog: int = 64
    candidate_parent_limit: int = 4


@dataclass
class TickEvents:
    """One tick's event sets, as index arrays into the population."""

    tick: int
    joins: np.ndarray
    leaves: np.ndarray
    fails: np.ndarray
    announcers: np.ndarray
    downloaders: np.ndarray

    @property
    def total(self) -> int:
        return (
            len(self.joins) + len(self.leaves) + len(self.fails)
            + len(self.announcers) + len(self.downloaders)
        )


class ColumnarPopulation:
    """Slot-matrix synthetic peer population (§18 technique applied to
    the *simulator*): peer state is struct-of-arrays, tick event sets
    are drawn with whole-array bernoulli masks, and per-peer Python
    (Host materialization) runs only for peers an event touched."""

    def __init__(self, config: Optional[FleetConfig] = None) -> None:
        self.config = config or FleetConfig()
        n = self.config.num_peers
        self.rng = np.random.default_rng(self.config.seed)
        r = self.rng
        shares = np.array([c[1] for c in IDC_CLASSES])
        self.idc_class = r.choice(
            len(IDC_CLASSES), size=n, p=shares / shares.sum()
        ).astype(np.uint8)
        self.state = np.full(n, _OFFLINE, dtype=np.uint8)
        # Latent host attributes, columnar (no LatentHost objects).
        self.idc = r.integers(0, len(IDC_NAMES), n).astype(np.int16)
        self.region = r.integers(0, len(REGIONS), n).astype(np.int8)
        self.zone = r.integers(0, 4, n).astype(np.int8)
        self.up_cap = np.exp(r.normal(math.log(60e6), 0.7, n)).astype(np.float32)
        self.cpu_load = np.clip(r.beta(2, 5, n), 0, 1).astype(np.float32)
        self.mem_load = np.clip(r.beta(2, 4, n), 0, 1).astype(np.float32)
        self.upload_count = r.integers(10, 5000, n).astype(np.int64)
        self.upload_failed = (
            self.upload_count * np.clip(r.beta(1, 12, n), 0, 1)
        ).astype(np.int64)
        # Per-class rate columns, broadcast once.
        joins = np.array([c[2] for c in IDC_CLASSES])
        leaves = np.array([c[3] for c in IDC_CLASSES])
        fails = np.array([c[4] for c in IDC_CLASSES])
        self._join_rate = joins[self.idc_class]
        self._leave_rate = leaves[self.idc_class]
        self._fail_rate = fails[self.idc_class]
        self._hosts: Dict[int, Host] = {}
        self.tick_count = 0

    # -- vectorized event draws ----------------------------------------------

    def tick(self) -> TickEvents:
        """Draw one discrete-event tick: state transitions applied
        columnar, event index arrays returned for the driver."""
        r = self.rng
        n = self.config.num_peers
        u = r.random(n)
        offline = self.state == _OFFLINE
        online = ~offline
        joins = np.flatnonzero(offline & (u < self._join_rate))
        # Independent draw for departures; a peer that joined this tick
        # stays for at least one tick (real daemons outlive one announce).
        v = r.random(n)
        leaves = np.flatnonzero(online & (v < self._leave_rate))
        fails = np.flatnonzero(
            online & (v >= self._leave_rate)
            & (v < self._leave_rate + self._fail_rate)
        )
        w = r.random(n)
        announcers = np.flatnonzero(online & (w < self.config.announce_rate))
        d = r.random(n)
        downloaders = np.flatnonzero(online & (d < self.config.download_rate))
        # Apply transitions columnar.
        self.state[joins] = _ONLINE
        self.state[leaves] = _OFFLINE
        self.state[fails] = _OFFLINE
        self.tick_count += 1
        return TickEvents(
            tick=self.tick_count,
            joins=joins,
            leaves=leaves,
            fails=fails,
            announcers=announcers,
            downloaders=downloaders,
        )

    def online_count(self) -> int:
        return int((self.state == _ONLINE).sum())

    # -- lazy Host materialization -------------------------------------------

    def host(self, i: int) -> Host:
        """The peer's scheduler Host view, built once on first touch —
        1M cold slots cost nothing until an event reaches one."""
        h = self._hosts.get(i)
        if h is None:
            h = Host(
                id=f"fleet-host-{i}",
                hostname=f"fleet-{i}",
                ip=f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}",
                port=8002,
                download_port=8001,
                type=HostType.NORMAL,
                concurrent_upload_limit=50,
            )
            h.stats.network.idc = IDC_NAMES[self.idc[i]]
            h.stats.network.location = (
                f"{REGIONS[self.region[i]]}|zone-{self.zone[i]}"
                f"|rack-{i % 8}"
            )
            h.upload_count = int(self.upload_count[i])
            h.upload_failed_count = int(self.upload_failed[i])
            self._hosts[i] = h
        # Announce-time stats refresh from the latent columns (cheap
        # scalar reads; the service's adopt/touch does the column write).
        h.stats.cpu.percent = float(self.cpu_load[i]) * 100.0
        h.stats.memory.used_percent = float(self.mem_load[i]) * 100.0
        return h

    def forget(self, i: int) -> None:
        """Drop a departed peer's Host view (its next join rebuilds)."""
        self._hosts.pop(i, None)


# -- the sharded fleet --------------------------------------------------------


@dataclass
class _Shard:
    shard_id: str
    service: SchedulerService
    guard: ShardGuard
    cache: HostFeatureCache
    announces: int = 0
    registers: int = 0
    redirects_followed: int = 0


class ShardedFleet:
    """N real in-process scheduler shards behind one ShardRing."""

    def __init__(
        self,
        n_shards: int,
        *,
        feature_cache_hosts: int = 65536,
        candidate_parent_limit: int = 4,
        admission: bool = False,
        storage=None,
    ) -> None:
        self._feature_cache_hosts = feature_cache_hosts
        self._candidate_parent_limit = candidate_parent_limit
        self._admission = admission
        self._storage = storage
        self.shards: Dict[str, _Shard] = {}
        members: Dict[str, str] = {}
        for i in range(n_shards):
            sid = f"shard-{i}"
            self.shards[sid] = self._make_shard(sid)
            members[sid] = f"inproc://{sid}"
        self.ring = ShardRing(members, version=1)
        for shard in self.shards.values():
            shard.guard.update_ring(self.ring)

    def _make_shard(self, sid: str) -> _Shard:
        cache = HostFeatureCache(max_hosts=self._feature_cache_hosts)
        ctl = AdmissionController() if self._admission else None
        guard = ShardGuard(sid, admission=ctl)
        service = SchedulerService(
            Resource(),
            Scheduling(
                Evaluator(feature_cache=cache),
                SchedulingConfig(
                    retry_interval=0,
                    candidate_parent_limit=self._candidate_parent_limit,
                ),
            ),
            self._storage,
            None,
            shard_guard=guard,
        )
        return _Shard(sid, service, guard, cache)

    # -- routing -------------------------------------------------------------

    def owner_of(self, key: str) -> _Shard:
        sid = self.ring.owner(key)
        if sid is None:
            raise LookupError("fleet has no live shards")
        return self.shards[sid]

    def live(self) -> List[_Shard]:
        return [self.shards[sid] for sid in self.ring.members()]

    # -- membership change ---------------------------------------------------

    def kill(self, shard_id: str) -> Dict[str, int]:
        """Remove a member: bump the ring, push it to every survivor
        (their guards run the handoff sweep).  Returns per-survivor
        handed-off task counts — the migration evidence."""
        dead = self.shards.pop(shard_id, None)
        if dead is None:
            raise KeyError(shard_id)
        members = self.ring.members()
        members.pop(shard_id, None)
        self.ring = ShardRing(
            members, replicas=self.ring.replicas,
            version=self.ring.version + 1,
        )
        moved: Dict[str, int] = {}
        for shard in self.shards.values():
            moved[shard.shard_id] = len(shard.guard.update_ring(self.ring))
        return moved

    def add_shard(self, shard_id: Optional[str] = None) -> Dict[str, int]:
        """Scale-out: a new member joins, the ring bumps, and every
        EXISTING shard's handoff sweep marks the tasks the newcomer now
        owns — their peers get steered there on their next call (the
        consistent-hash add moves only ≈K/(N+1) keys, all TO the
        newcomer; the property tests pin the bound).  Returns
        per-survivor handed-off task counts."""
        sid = shard_id or f"shard-{len(self.shards)}-r{self.ring.version}"
        if sid in self.shards:
            raise KeyError(f"shard {sid} already exists")
        members = self.ring.members()
        members[sid] = f"inproc://{sid}"
        self.ring = ShardRing(
            members, replicas=self.ring.replicas,
            version=self.ring.version + 1,
        )
        moved: Dict[str, int] = {}
        for shard in self.shards.values():
            moved[shard.shard_id] = len(shard.guard.update_ring(self.ring))
        newcomer = self._make_shard(sid)
        self.shards[sid] = newcomer
        newcomer.guard.update_ring(self.ring)
        return moved

    # -- aggregate stats -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        per = {
            s.shard_id: {
                "announces": s.announces,
                "registers": s.registers,
                "hosts": len(s.service.resource.host_manager),
                "tasks": len(s.service.resource.task_manager),
                "cache_hits": s.cache.hits,
                "cache_misses": s.cache.misses,
            }
            for s in self.shards.values()
        }
        hits = sum(p["cache_hits"] for p in per.values())
        misses = sum(p["cache_misses"] for p in per.values())
        return {
            "shards": per,
            "announces": sum(p["announces"] for p in per.values()),
            "registers": sum(p["registers"] for p in per.values()),
            "cache_hit_rate": hits / max(1, hits + misses),
        }


class FleetSwarmDriver:
    """Applies population ticks to the fleet through the real service
    entry points, following steering answers like a wire client."""

    def __init__(
        self,
        population: ColumnarPopulation,
        fleet: ShardedFleet,
    ) -> None:
        self.population = population
        self.fleet = fleet
        # The driver routes through its OWN ring snapshot, like a wire
        # client between dynconfig polls: a membership change leaves it
        # stale until a dead member or a steering answer forces the
        # refresh — so the REDIRECT protocol is exercised by the sim,
        # not bypassed by omniscience.
        self._ring = fleet.ring
        cfg = population.config
        self._urls = [
            f"https://origin.example.com/fleet-blob/{t}"
            for t in range(cfg.task_catalog)
        ]
        self._task_ids = [idgen.task_id(u) for u in self._urls]
        self.downloads_ok = 0
        self.downloads_failed = 0
        self.sheds = 0
        self.announce_seconds = 0.0
        self.rehomed_tasks = 0

    # -- client-side routing (stale-ring semantics) ---------------------------

    def _route(self, key: str) -> _Shard:
        """Route via the driver's ring snapshot; a dead member (the
        connection-refused analog) triggers the snapshot refresh and one
        re-route — the client half of kill-migration."""
        sid = self._ring.owner(key)
        shard = self.fleet.shards.get(sid) if sid is not None else None
        if shard is None:
            self._ring = self.fleet.ring
            sid = self._ring.owner(key)
            shard = self.fleet.shards.get(sid) if sid is not None else None
            if shard is None:
                raise LookupError("fleet has no live shards")
        return shard

    # -- per-event application ----------------------------------------------

    def _announce(self, i: int) -> None:
        host = self.population.host(i)
        shard = self._route(host.id)
        t0 = time.perf_counter()
        try:
            shard.service.announce_host(host)
        except ShardSaturatedError:
            self.sheds += 1
            return
        finally:
            self.announce_seconds += time.perf_counter() - t0
        shard.announces += 1

    def _download(self, i: int) -> None:
        """One synthetic download through the task's ring owner: register
        → batched piece reports → finished.  Wrong-shard steering is
        followed once, like the wire router."""
        pop = self.population
        cfg = pop.config
        t = int(pop.rng.integers(0, len(self._urls)))
        url, tid = self._urls[t], self._task_ids[t]
        host = pop.host(i)
        shard = self._route(tid)
        try:
            try:
                result = shard.service.register_peer(
                    host=host, url=url, task_id=tid
                )
            except WrongShardError as exc:
                # Stale routing (ring moved): follow the steering answer
                # and adopt the fresher ring it implies.
                owner = self.fleet.shards.get(exc.owner_id)
                self._ring = self.fleet.ring
                if owner is None:
                    self.downloads_failed += 1
                    return
                shard = owner
                shard.redirects_followed += 1
                result = shard.service.register_peer(
                    host=host, url=url, task_id=tid
                )
        except ShardSaturatedError:
            self.sheds += 1
            return
        shard.registers += 1
        peer = result.peer
        task = peer.task
        if task.content_length < 0:
            task.content_length = cfg.pieces_per_download * PIECE_SIZE
            task.total_piece_count = cfg.pieces_per_download
            task.piece_size = PIECE_SIZE
        schedule = result.schedule
        parents = (
            schedule.parents
            if schedule is not None
            and schedule.kind is ScheduleResultKind.PARENTS
            else []
        )
        bw = max(float(pop.up_cap[i]), 1e3)
        pieces = [
            {
                "number": n,
                "parent_id": parents[n % len(parents)].id if parents else "",
                "length": PIECE_SIZE,
                "cost_ns": int(PIECE_SIZE / bw * 1e9),
            }
            for n in range(task.total_piece_count)
        ]
        try:
            shard.service.report_pieces_finished(peer, pieces)
            shard.service.report_peer_finished(peer)
        except WrongShardError:
            # Task handed off mid-download: the client re-registers on
            # the new owner and the download restarts there.
            new_owner = self.fleet.owner_of(tid)
            self.rehomed_tasks += 1
            try:
                res2 = new_owner.service.register_peer(
                    host=host, url=url, task_id=tid
                )
                new_owner.registers += 1
                p2 = res2.peer
                if p2.task.content_length < 0:
                    p2.task.content_length = task.content_length
                    p2.task.total_piece_count = task.total_piece_count
                    p2.task.piece_size = task.piece_size
                new_owner.service.report_pieces_finished(p2, pieces)
                new_owner.service.report_peer_finished(p2)
            except (WrongShardError, ShardSaturatedError):
                self.downloads_failed += 1
                return
        self.downloads_ok += 1

    # -- tick application ----------------------------------------------------

    def apply(self, events: TickEvents) -> None:
        pop = self.population
        for i in events.joins:
            self._announce(int(i))
        for i in events.announcers:
            self._announce(int(i))
        for i in events.downloaders:
            self._download(int(i))
        for i in events.leaves:
            host = pop._hosts.get(int(i))
            if host is not None:
                try:
                    self._route(host.id).service.leave_host(host)
                except LookupError:
                    pass
            pop.forget(int(i))
        # Fails: the box died — no leave reaches the scheduler; the
        # host ages out of the TTL GC exactly like a real power loss.
        for i in events.fails:
            pop.forget(int(i))

    def run(self, ticks: int) -> Dict[str, object]:
        """Drive ``ticks`` ticks; returns the aggregate workload report
        (the bench's measured unit)."""
        t0 = time.perf_counter()
        totals = {"joins": 0, "leaves": 0, "fails": 0, "announces": 0,
                  "downloads": 0}
        for _ in range(ticks):
            ev = self.population.tick()
            totals["joins"] += len(ev.joins)
            totals["leaves"] += len(ev.leaves)
            totals["fails"] += len(ev.fails)
            totals["announces"] += len(ev.joins) + len(ev.announcers)
            totals["downloads"] += len(ev.downloaders)
            self.apply(ev)
        wall = time.perf_counter() - t0
        stats = self.fleet.stats()
        announces = int(stats["announces"])
        return {
            **totals,
            "wall_s": wall,
            "announce_wall_s": self.announce_seconds,
            "announces_served": announces,
            "announces_per_sec": (
                announces / self.announce_seconds
                if self.announce_seconds > 0 else 0.0
            ),
            "downloads_ok": self.downloads_ok,
            "downloads_failed": self.downloads_failed,
            "sheds": self.sheds,
            "rehomed_tasks": self.rehomed_tasks,
            "online": self.population.online_count(),
            "unique_hosts": sum(
                s["hosts"] for s in stats["shards"].values()  # type: ignore[index]
            ),
            "cache_hit_rate": stats["cache_hit_rate"],
            "shards": stats["shards"],
        }


# -- seed-sweep reproducibility (DESIGN.md §27) ------------------------------

# Keys of the run report that measure WALL TIME rather than simulated
# behavior.  Everything else is a pure function of (FleetConfig, ticks):
# the population draws from a seeded numpy Generator and the fleet is
# driven synchronously, so two runs with the same seed — even under
# different PYTHONHASHSEED values — must agree byte-for-byte on the
# projection below (tests/test_sim_determinism.py gates this in
# subprocesses).
TIMING_KEYS = ("wall_s", "announce_wall_s", "announces_per_sec")


def deterministic_summary(report: Dict[str, object]) -> Dict[str, object]:
    """The seed-reproducible core of ``FleetSwarmDriver.run``'s report:
    the full report minus the wall-clock measurements."""
    return {k: v for k, v in report.items() if k not in TIMING_KEYS}
