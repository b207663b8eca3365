"""Port parity: the sharded scheduler fleet, ``dragonfly2_tpu_torch`` against
``dragonfly2_tpu`` (``scheduler/sharding.py``, the service's guard seam,
``rpc/resolver.py``, ``rpc/steering.py``, the scheduler binary's guard,
``sim/fleet.py``).

The port counterparts of ``tests/test_sharding.py``'s classes (ring
properties, the directory, the manager's publication, the guard,
admission, the wire answers, the router, the fleet simulator), each run
against the port, and the cross-package checks:

- ``owner`` of 10,000 task ids on rings of 1-5 members is equal in both
  packages; ``to_payload`` is JSON-equal and each package's
  ``from_payload`` of the other's places every key alike; the
  bounded-load ``pick`` is equal under the same loads;
- the same ``observe`` / ``admit`` / ``track`` sequence under a fixed
  clock gives the same admit-or-shed answers and ``retry_after_s``,
  with and without ``TenantAccounting``;
- ``handoff`` marks the same task set;
- ``SteeringSchedulerClient`` over two port schedulers in serve mode
  routes each task to the owner the JAX ring names, and follows one 421;
- the port's ``serve`` builds the guard as the reference's ``run`` does:
  admission at the config's defaults (512, 50 ms), none at
  ``shard_max_inflight: 0``, and the SLO autopilot only with a metric
  journal and declared SLOs.

Each cross-package check also runs on a planted fault in the port (a
``hash()``-placed ring, admission that ignores priority, a handoff that
marks nothing) and must then fail.  The gRPC steering parity is in
``tests/test_torch_grpc.py``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import dragonfly2_tpu.qos.accounting as j_acct  # noqa: E402
import dragonfly2_tpu.qos.policy as j_policy  # noqa: E402
import dragonfly2_tpu.scheduler as j_sched  # noqa: E402
import dragonfly2_tpu.scheduler.sharding as j_sharding  # noqa: E402
import dragonfly2_tpu.utils.idgen as j_idgen  # noqa: E402
import dragonfly2_tpu_torch.qos.accounting as t_acct  # noqa: E402
import dragonfly2_tpu_torch.qos.policy as t_policy  # noqa: E402
import dragonfly2_tpu_torch.scheduler as t_sched  # noqa: E402
import dragonfly2_tpu_torch.scheduler.sharding as t_sharding  # noqa: E402
from dragonfly2_tpu_torch.manager.state import MemoryBackend  # noqa: E402
from dragonfly2_tpu_torch.scheduler import (  # noqa: E402
    AdmissionController,
    Resource,
    SchedulerService,
    ShardDirectory,
    ShardGuard,
    ShardRing,
    ShardSaturatedError,
    WrongShardError,
)
from dragonfly2_tpu_torch.scheduler.resource import Host  # noqa: E402
from dragonfly2_tpu_torch.utils import idgen  # noqa: E402
from dragonfly2_tpu_torch.utils.types import Priority  # noqa: E402

KEYS = [f"task-{i:04d}" for i in range(1000)]
TASK_IDS = [idgen.task_id(f"https://origin.example/blob-{i}") for i in range(10_000)]


def _ring(n: int, **kw) -> ShardRing:
    return ShardRing({f"s{i}": f"http://s{i}:8002" for i in range(n)}, **kw)


def _service(guard=None, pkg=t_sched) -> SchedulerService:
    return pkg.SchedulerService(
        pkg.Resource(),
        pkg.Scheduling(pkg.Evaluator(), pkg.SchedulingConfig(retry_interval=0)),
        None,
        None,
        shard_guard=guard,
    )


def _host(i: int = 0, cls=Host) -> Host:
    h = cls(id=f"shg-host-{i}", hostname=f"shg{i}", ip=f"10.9.0.{i}",
            port=8002, download_port=8001)
    h.stats.network.idc = "idc-a"
    return h


def _hash_placed(key: str) -> int:
    """The planted fault: a ring position from the interpreter's salted
    ``hash()`` instead of sha1."""
    return hash(key) & ((1 << 64) - 1)


# -- the reference's classes, run against the port ---------------------------


class TestRingProperties:
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_balance_bound(self, n):
        ring = _ring(n)
        counts = Counter(ring.owner(k) for k in KEYS)
        assert len(counts) == n, "some shard owns nothing at 1k keys"
        assert max(counts.values()) <= 1.6 * len(KEYS) / n, counts

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_minimal_movement_on_add(self, n):
        ring = _ring(n)
        before = {k: ring.owner(k) for k in KEYS}
        ring.add("s-new", "http://new:8002")
        after = {k: ring.owner(k) for k in KEYS}
        moved = {k for k in KEYS if before[k] != after[k]}
        assert len(moved) <= math.ceil(len(KEYS) / n)
        assert all(after[k] == "s-new" for k in moved)

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_minimal_movement_on_remove(self, n):
        ring = _ring(n + 1)
        before = {k: ring.owner(k) for k in KEYS}
        ring.remove(f"s{n}")
        after = {k: ring.owner(k) for k in KEYS}
        moved = {k for k in KEYS if before[k] != after[k]}
        assert moved == {k for k in KEYS if before[k] == f"s{n}"}
        assert len(moved) <= math.ceil(len(KEYS) / (n + 1)) * 2

    def test_deterministic_across_processes(self):
        """A child interpreter with another PYTHONHASHSEED places every
        key of the sample on the same member."""
        ring = _ring(4)
        sample = KEYS[::97]
        mine = {k: ring.owner(k) for k in sample}
        script = (
            "import json,sys\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "from dragonfly2_tpu_torch.scheduler.sharding import ShardRing\n"
            "ring = ShardRing({f's{i}': '' for i in range(4)})\n"
            "keys = json.loads(sys.argv[2])\n"
            "print(json.dumps({k: ring.owner(k) for k in keys}))\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", script, str(REPO), json.dumps(sample)],
            env={**os.environ, "PYTHONHASHSEED": "12345"},
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout) == mine

    def test_bounded_load_pick_spills_past_hot_owner(self):
        ring = _ring(4)
        key = KEYS[0]
        owner = ring.owner(key)
        loads = {sid: 10.0 for sid in ring.members()}
        assert ring.pick(key, load_of=loads.get) == owner
        loads[owner] = 1000.0
        assert ring.pick(key, load_of=loads.get) != owner
        assert ring.pick(key, load_of=lambda s: 1000.0) == owner

    def test_payload_round_trip(self):
        ring = _ring(3, version=7)
        clone = ShardRing.from_payload(ring.to_payload())
        assert clone.version == 7 and clone.members() == ring.members()
        assert [clone.owner(k) for k in KEYS[:50]] == [ring.owner(k) for k in KEYS[:50]]


class TestShardDirectory:
    def test_version_bumps_only_on_membership_change(self):
        d = ShardDirectory(MemoryBackend())
        p1 = d.publish("default", [("a", "http://a"), ("b", "http://b")])
        p2 = d.publish("default", [("b", "http://b"), ("a", "http://a")])
        assert p1["version"] == p2["version"] == 1
        p3 = d.publish("default", [("a", "http://a")])
        assert p3["version"] == 2 and [m["id"] for m in p3["members"]] == ["a"]

    def test_ring_version_survives_reload(self):
        backend = MemoryBackend()
        d = ShardDirectory(backend)
        d.publish("default", [("a", "http://a")])
        d.publish("default", [("a", "http://a"), ("b", "http://b")])
        d2 = ShardDirectory(backend)
        assert d2.version("default") == 2
        assert d2.publish("default", [("a", "http://a"), ("b", "http://b")])["version"] == 2


class TestManagerRingPublication:
    def test_cluster_config_carries_versioned_ring(self):
        import urllib.request

        from dragonfly2_tpu_torch.manager.cluster import ClusterManager
        from dragonfly2_tpu_torch.manager.registry import ModelRegistry
        from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer

        clusters = ClusterManager()
        server = ManagerRESTServer(ModelRegistry(), clusters)
        server.serve()
        try:
            base = f"http://{server.address[0]}:{server.address[1]}"

            def post(path, body):
                req = urllib.request.Request(
                    base + path, data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"},
                )
                return json.loads(urllib.request.urlopen(req).read())

            def config():
                with urllib.request.urlopen(base + "/api/v1/clusters/default:config") as r:
                    return json.loads(r.read())

            for sid, port in (("sa", 18001), ("sb", 18002)):
                post("/api/v1/schedulers", {"id": sid, "cluster_id": "default",
                                            "ip": "127.0.0.1", "port": port})
            ring = config()["scheduler_ring"]
            assert ring["version"] == 1
            assert [m["id"] for m in ring["members"]] == ["sa", "sb"]
            assert ring["members"][0]["url"] == "http://127.0.0.1:18001"
            assert config()["scheduler_ring"]["version"] == 1
            with clusters._mu:
                clusters._schedulers["sb"].last_keepalive = 0.0
            ring2 = config()["scheduler_ring"]
            assert ring2["version"] == 2 and [m["id"] for m in ring2["members"]] == ["sa"]
        finally:
            server.stop()


def _url_owned_by(ring, sid, prefix="https://origin/"):
    return next(f"{prefix}{i}" for i in range(400)
                if ring.owner(idgen.task_id(f"{prefix}{i}")) == sid)


class TestShardGuard:
    def test_wrong_shard_register_steers(self):
        ring = _ring(2, version=1)
        url = _url_owned_by(ring, "s1")
        guard = ShardGuard("s0")
        service = _service(guard)
        guard.update_ring(ring)
        with pytest.raises(WrongShardError) as exc:
            service.register_peer(host=_host(), url=url)
        assert exc.value.owner_id == "s1" and exc.value.ring_version == 1
        assert len(service.resource.task_manager) == 0
        assert len(service.resource.peer_manager) == 0

    def test_handoff_marks_moved_tasks_and_opens_span(self):
        from dragonfly2_tpu_torch.utils import tracing

        guard = ShardGuard("s0")
        service = _service(guard)
        guard.update_ring(ShardRing({"s0": ""}, version=1))
        done = [service.register_peer(host=_host(i), url=f"https://o/{i}").peer
                for i in range(40)]
        prev = tracing.default_tracer.exporter
        exporter = tracing.InMemoryExporter()
        tracing.default_tracer.exporter = exporter
        try:
            moved = guard.update_ring(_ring(4, version=2))
        finally:
            tracing.default_tracer.exporter = prev
        assert 0 < len(moved) < 40
        spans = exporter.find("scheduler/shard.handoff")
        assert spans and spans[0].attributes["tasks_moved"] == len(moved)
        victim = next(p for p in done if p.task.id in set(moved))
        with pytest.raises(WrongShardError):
            service.report_piece_finished(victim, 0, parent_id="", length=1)
        with pytest.raises(WrongShardError):
            service.report_peer_finished(victim)

    def test_stale_ring_version_is_ignored(self):
        guard = ShardGuard("s0")
        guard.resource = Resource()
        guard.update_ring(_ring(2, version=5))
        assert guard.update_ring(_ring(4, version=4)) == []
        assert guard.ring_version() == 5

    def test_on_config_adopts_published_ring(self):
        guard = ShardGuard("s0")
        guard.resource = Resource()
        guard.on_config({"scheduler_ring": _ring(3, version=9).to_payload()})
        assert guard.ring_version() == 9
        guard.on_config({"scheduler_ring": {"members": []}})
        assert guard.ring_version() == 9

    def test_qos_policy_reaches_admission_accounting(self):
        """``set_qos_policy`` installs the tenant table into the guard's
        admission accounting (and makes one when there is none)."""
        policy = t_policy.QoSPolicy.from_payload({"t-a": {"announce_qps": 5.0}})
        guard = ShardGuard("s0", admission=AdmissionController())
        service = _service(guard)
        service.set_qos_policy(policy)
        assert guard.admission.accounting is not None
        assert guard.admission.accounting.policy is policy


class TestAdmissionControl:
    def _saturated(self) -> AdmissionController:
        ctl = AdmissionController(max_inflight=4, p99_budget_s=0.010)
        for _ in range(64):
            ctl.observe(0.100)
        return ctl

    def test_sheds_lowest_priority_first(self):
        ctl = self._saturated()
        assert ctl.overload() > 0.0
        with pytest.raises(ShardSaturatedError) as exc:
            ctl.admit(Priority.LEVEL6)
        assert exc.value.retry_after_s > 0
        ctl.admit(Priority.LEVEL0)

    def test_inside_budget_admits_everyone(self):
        ctl = AdmissionController(max_inflight=64, p99_budget_s=1.0)
        for _ in range(16):
            ctl.observe(0.001)
        for level in (Priority.LEVEL0, Priority.LEVEL3, Priority.LEVEL6):
            ctl.admit(level)

    def test_hard_wall_sheds_even_level0(self):
        ctl = AdmissionController(max_inflight=1)
        tracks = [ctl.track().__enter__() for _ in range(2)]
        try:
            with pytest.raises(ShardSaturatedError):
                ctl.admit(Priority.LEVEL0)
        finally:
            for t in tracks:
                t.__exit__(None, None, None)

    def test_window_recovers_after_burst(self):
        ctl = AdmissionController(max_inflight=64, p99_budget_s=0.010, window_s=0.05)
        for _ in range(64):
            ctl.observe(0.100)
        assert ctl.overload() > 0.0
        time.sleep(0.06)
        for _ in range(64):
            ctl.observe(0.001)
        time.sleep(0.06)
        ctl.observe(0.001)
        assert ctl.overload() == 0.0


class TestShardWire:
    def test_wrong_shard_answer_rides_the_wire(self):
        from dragonfly2_tpu_torch.rpc import RemoteScheduler, SchedulerHTTPServer

        ring = _ring(2, version=3)
        guard = ShardGuard("s0")
        service = _service(guard)
        guard.update_ring(ring)
        server = SchedulerHTTPServer(service)
        server.serve()
        try:
            client = RemoteScheduler(server.url, timeout=5.0)
            client.announce_host(_host(1))
            # The announce answer re-publishes the adopted ring.
            assert client.scheduler_ring == ring.to_payload()
            with pytest.raises(WrongShardError) as exc:
                client.register_peer(host=_host(1), url=_url_owned_by(ring, "s1"))
            assert exc.value.owner_id == "s1"
            assert exc.value.owner_url == "http://s1:8002"
            assert exc.value.ring_version == 3
        finally:
            server.stop()

    def test_saturated_answer_carries_retry_after(self):
        from dragonfly2_tpu_torch.rpc import RemoteScheduler, SchedulerHTTPServer

        ctl = AdmissionController(max_inflight=4, p99_budget_s=0.001)
        for _ in range(64):
            ctl.observe(1.0)
        service = _service(ShardGuard("s0", admission=ctl))
        server = SchedulerHTTPServer(service)
        server.serve()
        try:
            client = RemoteScheduler(server.url, timeout=5.0)
            with pytest.raises(ShardSaturatedError) as exc:
                client.register_peer(host=_host(2), url="https://origin/shed",
                                     priority=Priority.LEVEL6)
            assert exc.value.retry_after_s > 0
        finally:
            server.stop()


class TestShardRouter:
    def _fleet(self, ring):
        from dragonfly2_tpu_torch.rpc.resolver import ShardRouter

        class _Stub:
            def __init__(self, service):
                self.service = service

        services = {}
        for sid, url in ring.members().items():
            guard = ShardGuard(sid)
            services[url] = _service(guard)
            guard.update_ring(ring)
        return ShardRouter(factory=lambda url: _Stub(services[url])), services

    def test_routes_by_ring_and_follows_redirect(self):
        ring = _ring(2, version=1)
        router, services = self._fleet(ring)
        router.on_config({"scheduler_ring": ring.to_payload()})
        assert router.version == 1
        url = "https://origin/route-1"
        tid = idgen.task_id(url)
        res = router.call(tid, lambda c: c.service.register_peer(host=_host(3), url=url))
        assert res.peer.task.id == tid
        assert len(services[ring.url_of(ring.owner(tid))].resource.task_manager) == 1

    def test_redirect_answer_reroutes_to_hinted_owner(self):
        ring = _ring(2, version=2)
        router, services = self._fleet(ring)
        router.on_config({"scheduler_ring": {
            "version": 1, "members": [{"id": "s0", "url": "http://s0:8002"}]}})
        url = _url_owned_by(ring, "s1", "https://origin/redir-")
        tid = idgen.task_id(url)
        res = router.call(tid, lambda c: c.service.register_peer(host=_host(4), url=url))
        assert res.peer.task.id == tid
        assert len(services["http://s1:8002"].resource.task_manager) == 1


class TestFleetSim:
    def test_population_tick_conserves_states(self):
        from dragonfly2_tpu_torch.sim import ColumnarPopulation, FleetConfig

        pop = ColumnarPopulation(FleetConfig(num_peers=5000, seed=3))
        for _ in range(5):
            ev = pop.tick()
            assert not (set(ev.joins) & set(ev.leaves))
            assert not (set(ev.leaves) & set(ev.fails))
        assert 0 < pop.online_count() <= 5000

    def test_kill_and_add_migrate_without_losing_downloads(self):
        from dragonfly2_tpu_torch.sim import (
            ColumnarPopulation, FleetConfig, FleetSwarmDriver, ShardedFleet,
        )

        pop = ColumnarPopulation(FleetConfig(num_peers=3000, seed=11, download_rate=0.02))
        fleet = ShardedFleet(3, feature_cache_hosts=2048)
        driver = FleetSwarmDriver(pop, fleet)
        driver.run(2)
        assert driver.downloads_ok > 0
        fleet.kill(sorted(fleet.shards)[-1])
        driver.run(1)
        moved = fleet.add_shard("shard-late")
        driver.run(2)
        assert driver.downloads_failed == 0
        assert sum(moved.values()) > 0
        assert sum(s.redirects_followed for s in fleet.shards.values()) > 0


# -- cross-package checks, each with a planted fault --------------------------


def _owners(ring_cls, n):
    ring = ring_cls({f"s{i}": f"http://s{i}:8002" for i in range(n)}, version=n)
    return [ring.owner(t) for t in TASK_IDS]


@pytest.mark.parametrize("fault", [None, "hash_ring"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_owners_equal_across_packages(monkeypatch, n, fault):
    if fault:
        monkeypatch.setattr(t_sharding, "shard_hash", _hash_placed)
    same = _owners(t_sharding.ShardRing, n) == _owners(j_sharding.ShardRing, n)
    # One member owns everything whatever the hash: the fault shows from 2.
    assert same is (fault is None or n == 1)


@pytest.mark.parametrize("fault", [None, "hash_ring"])
def test_payloads_and_picks_equal_across_packages(monkeypatch, fault):
    if fault:
        monkeypatch.setattr(t_sharding, "shard_hash", _hash_placed)
    members = {f"sched-{i}": f"http://127.0.0.1:{9000 + i}" for i in range(5)}
    tring = t_sharding.ShardRing(members, version=7)
    jring = j_sharding.ShardRing(members, version=7)
    assert json.dumps(tring.to_payload(), sort_keys=True) == json.dumps(
        jring.to_payload(), sort_keys=True)
    loads = dict(zip(members, np.random.default_rng(3).uniform(0, 10, 5).tolist()))
    hot = max(loads, key=loads.get)
    loads[hot] *= 20.0
    picks = [(tring.pick(t, load_of=loads.get), jring.pick(t, load_of=loads.get))
             for t in TASK_IDS[:2000]]
    crossed = [(t_sharding.ShardRing.from_payload(jring.to_payload()).owner(t),
                j_sharding.ShardRing.from_payload(tring.to_payload()).owner(t))
               for t in TASK_IDS[:2000]]
    same = all(a == b for a, b in picks) and all(a == jring.owner(t) == b for (a, b), t
                                                 in zip(crossed, TASK_IDS[:2000]))
    assert same is (fault is None)
    if fault is None:
        # The hot member is past the bound: the walk spills past it.
        assert all(p != hot for p, _ in picks)


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


QOS_PAYLOAD = {
    "t-gold": {"tenant_class": "gold", "priority": 0, "weight": 4.0},
    "t-bg": {"tenant_class": "bronze", "priority": 5, "weight": 1.0,
             "announce_qps": 20.0, "announce_burst": 4},
    "t-noisy": {"tenant_class": "silver", "priority": 2, "weight": 2.0,
                "announce_qps": 50.0},
}


def _admission_script(sharding, acct_mod, policy_mod, clock, accounting):
    priority = sharding.Priority
    """One fixed script of observe / admit / track calls under ``clock``;
    → the answers (admitted, or shed with retry_after_s and reason)."""
    acct = None
    if accounting:
        acct = acct_mod.TenantAccounting(policy_mod.QoSPolicy.from_payload(QOS_PAYLOAD))
    ctl = sharding.AdmissionController(max_inflight=8, p99_budget_s=0.020, window_s=2.0,
                                       accounting=acct)
    rng = np.random.default_rng(11)
    tenants = ["", "t-gold", "t-bg", "t-noisy"]
    answers, open_tracks = [], []
    for step in range(600):
        clock.now += float(rng.uniform(0.0, 0.05))
        kind = rng.integers(0, 10)
        if kind < 3:
            # Latency that drifts from inside the budget to 3x past it.
            ctl.observe(float(rng.uniform(0.001, 0.02 + 0.04 * (step % 200) / 200)))
        elif kind < 4 and len(open_tracks) < 20:
            open_tracks.append(ctl.track().__enter__())
        elif kind < 5 and open_tracks:
            clock.now += 0.01
            open_tracks.pop().__exit__(None, None, None)
        else:
            level = int(rng.integers(0, 7))
            tenant = tenants[int(rng.integers(0, 4))]
            try:
                ctl.admit(priority(level), tenant=tenant)
                answers.append(("ok", level, tenant))
            except Exception as exc:
                answers.append(("shed", level, tenant, round(exc.retry_after_s, 9),
                                exc.reason))
        if step % 150 == 149:
            ctl.set_shed_bias(0.3 if step < 400 else 0.0)
    return answers


def _priority_blind_admit(orig):
    def admit(self, priority=Priority.LEVEL0, *, tenant=""):
        return orig(self, Priority.LEVEL6, tenant=tenant)
    return admit


@pytest.mark.parametrize("fault", [None, "priority_blind"])
@pytest.mark.parametrize("accounting", [False, True])
def test_admission_answers_equal_across_packages(monkeypatch, accounting, fault):
    clock = _Clock()
    for mod in (t_sharding, j_sharding, t_acct, j_acct):
        monkeypatch.setattr(mod, "time", clock)
    if fault:
        monkeypatch.setattr(t_sharding.AdmissionController, "admit",
                            _priority_blind_admit(t_sharding.AdmissionController.admit))
    clock.now = 1000.0
    port = _admission_script(t_sharding, t_acct, t_policy, clock, accounting)
    clock.now = 1000.0
    ref = _admission_script(j_sharding, j_acct, j_policy, clock, accounting)
    sheds = sum(1 for a in ref if a[0] == "shed")
    assert 0 < sheds < len(ref), "the script must both admit and shed"
    assert (port == ref) is (fault is None)


def _mark_nothing(self, ring):
    return []


@pytest.mark.parametrize("fault", [None, "handoff_marks_nothing"])
def test_handoff_marks_the_same_tasks_across_packages(monkeypatch, fault):
    if fault:
        monkeypatch.setattr(t_sharding.ShardGuard, "handoff", _mark_nothing)
    from dragonfly2_tpu.scheduler.resource import Host as JHost

    moved = {}
    for name, pkg, host_cls in (("torch", t_sched, Host), ("jax", j_sched, JHost)):
        guard = pkg.ShardGuard("s1")
        service = _service(guard, pkg)
        guard.update_ring(pkg.ShardRing({"s1": ""}, version=1))
        for i in range(120):
            service.register_peer(host=_host(i % 30, host_cls), url=f"https://o/handoff-{i}")
        moved[name] = sorted(guard.update_ring(pkg.ShardRing(
            {f"s{i}": f"http://s{i}" for i in range(4)}, version=2)))
    assert 0 < len(moved["jax"]) < 120
    assert (moved["torch"] == moved["jax"]) is (fault is None)


# -- the daemon's steering client over two port schedulers --------------------


@pytest.fixture()
def two_schedulers(tmp_path):
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
    from dragonfly2_tpu_torch.config import SchedulerConfigFile

    servings = []
    try:
        for i in range(2):
            cfg = SchedulerConfigFile()
            cfg.server.host, cfg.server.port = "127.0.0.1", 0
            cfg.storage.dir = str(tmp_path / f"records{i}")
            cfg.scheduling.retry_interval_s = 0.0
            servings.append(scheduler_cli.serve(cfg, device="cpu", seed_trigger=False))
        yield servings
    finally:
        for s in servings:
            s.stop()


def test_steering_routes_to_the_jax_rings_owner_and_follows_one_421(two_schedulers):
    from dragonfly2_tpu_torch.rpc.steering import SteeringSchedulerClient
    from dragonfly2_tpu_torch.scheduler import metrics

    urls = [s.url for s in two_schedulers]
    jring = j_sharding.ShardRing({s.scheduler_id: s.url for s in two_schedulers}, version=1)
    tring = t_sharding.ShardRing.from_payload(jring.to_payload())
    for s in two_schedulers:
        assert s.shard_guard.update_ring(tring) == []
    by_id = {s.scheduler_id: s for s in two_schedulers}
    tasks = [f"https://origin.example/steer-{i}" for i in range(24)]

    # A client that has not announced routes by the url-hash bootstrap
    # ring; where that disagrees with the published ring the shard
    # answers 421 and the client follows the hint once.
    stale = SteeringSchedulerClient(urls)
    mismatch = next(u for u in (f"https://origin.example/stale-{i}" for i in range(200))
                    if stale._ring.pick(idgen.task_id(u))
                    != jring.url_of(jring.owner(j_idgen.task_id(u))))
    redirects0 = metrics.SHARD_REDIRECTS_TOTAL.value()
    res = stale.register_peer(host=_host(40), url=mismatch)
    assert metrics.SHARD_REDIRECTS_TOTAL.value() == redirects0 + 1
    owner = by_id[jring.owner(j_idgen.task_id(mismatch))]
    assert owner.service.resource.task_manager.load(res.peer.task.id) is not None

    # After one announce the client holds the published ring and every
    # task goes straight to the owner the JAX ring names.
    client = SteeringSchedulerClient(urls)
    client.announce_host(_host(41))
    assert client.ring_version() == 1
    redirects1 = metrics.SHARD_REDIRECTS_TOTAL.value()
    for url in tasks:
        tid = j_idgen.task_id(url)
        client.register_peer(host=_host(41), url=url)
        for sid, s in by_id.items():
            held = s.service.resource.task_manager.load(tid) is not None
            assert held is (sid == jring.owner(tid)), (url, sid)
    assert metrics.SHARD_REDIRECTS_TOTAL.value() == redirects1
    assert {jring.owner(j_idgen.task_id(u)) for u in tasks} == set(by_id)


def test_dfdaemon_builds_the_steering_client_for_a_list(tmp_path, two_schedulers):
    from dragonfly2_tpu_torch.cli import dfdaemon
    from dragonfly2_tpu_torch.config import DaemonConfig
    from dragonfly2_tpu_torch.rpc.steering import SteeringSchedulerClient

    dc = DaemonConfig()
    dc.storage.dir = str(tmp_path / "daemon")
    dc.server.host, dc.server.port = "127.0.0.1", 0
    dc.server.advertise_ip = "127.0.0.1"
    node = dfdaemon.build(dc, ",".join(s.url for s in two_schedulers))
    try:
        assert isinstance(node["client"], SteeringSchedulerClient)
        assert node["client"].backends() == sorted(s.url for s in two_schedulers)
        node["announcer"].announce_once()
        for s in two_schedulers:
            assert s.service.resource.host_manager.load(node["host"].id) is not None
    finally:
        node["announcer"].stop()
        node["piece_server"].stop()


# -- the scheduler binary's guard ---------------------------------------------


def _serve(tmp_path, **sched):
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
    from dragonfly2_tpu_torch.config import SchedulerConfigFile

    cfg = SchedulerConfigFile()
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.storage.dir = str(tmp_path / "records")
    for k, v in sched.items():
        setattr(cfg.scheduling, k, v)
    return cfg, scheduler_cli


def test_serve_builds_the_references_guard(tmp_path):
    from dragonfly2_tpu.config import SchedulerConfigFile as JConfig

    jdef = JConfig().scheduling
    cfg, cli = _serve(tmp_path)
    serving = cli.serve(cfg, device="cpu", seed_trigger=False)
    try:
        guard = serving.shard_guard
        assert serving.service.shard_guard is guard
        assert guard.shard_id == serving.scheduler_id
        assert guard.resource is serving.service.resource
        ctl = guard.admission
        assert (ctl.max_inflight, ctl.p99_budget_s) == (
            jdef.shard_max_inflight, jdef.shard_p99_budget_ms / 1e3) == (512, 0.05)
        assert isinstance(ctl.accounting, t_acct.TenantAccounting)
        assert serving.qos_autopilot is None
    finally:
        serving.stop()
    cfg, cli = _serve(tmp_path, shard_max_inflight=0)
    serving = cli.serve(cfg, device="cpu", seed_trigger=False)
    try:
        assert serving.shard_guard is not None and serving.shard_guard.admission is None
    finally:
        serving.stop()


SLOS = [{"name": "announce", "objective": "latency", "metric": "scheduler_announce_seconds",
         "threshold_ms": 50.0, "target": 0.99}]


@pytest.mark.parametrize("journal,slos,inflight,built", [
    (True, True, 512, True),
    (False, True, 512, False),
    (True, False, 512, False),
    (True, True, 0, False),
])
def test_serve_builds_the_autopilot_only_with_journal_and_slos(tmp_path, journal, slos,
                                                              inflight, built):
    from dragonfly2_tpu_torch.utils.metric_journal import MetricJournal

    cfg, cli = _serve(tmp_path, shard_max_inflight=inflight)
    if slos:
        cfg.telemetry.slos = SLOS
    j = MetricJournal(str(tmp_path / "m.dfmj"), service="scheduler", interval_s=60.0) \
        if journal else None
    serving = cli.serve(cfg, device="cpu", seed_trigger=False, journal=j)
    try:
        assert (serving.qos_autopilot is not None) is built
        if built:
            assert j.on_snapshot == serving.qos_autopilot.ingest
            assert serving.qos_autopilot.admission is serving.shard_guard.admission
    finally:
        serving.stop()
