"""Port parity: manager HA, ``dragonfly2_tpu_torch/manager/replication.py``
and its wiring (the REST routes, the ``ha`` config section, the HA metric
series) against ``dragonfly2_tpu/manager/replication.py``, with the client
half of HA that the port already had (``rpc/resolver.ManagerEndpoints``,
``rpc/retry.DecorrelatedJitterBackoff``, the breakers, and
``ModelSubscriber.pinned`` through a failover).

The reference's ``tests/test_replication.py``, case for case (but
``TestBenchReportStandbyNote``, which reads ``tools/bench_report``), each
run against both packages through ``pkg``.  Then the cases that cross the
packages: the lease and request signatures are equal bytes; a follower of
one package tails a leader of the other over REST and ends with the same
data rows; a replicated SQLite file a port leader wrote opens in the
reference and replays there.
"""

from __future__ import annotations

import importlib
import inspect
import io
import json
import logging
import random
import urllib.error
import urllib.request

import numpy as np
import pytest

PKG_NAMES = {"jax": "dragonfly2_tpu", "torch": "dragonfly2_tpu_torch"}


class Pkg:
    """One package's modules, by their relative names."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.root = PKG_NAMES[name]

    def __getattr__(self, rel: str):
        return importlib.import_module(f"{self.root}.{rel.replace('__', '.')}")


@pytest.fixture(params=sorted(PKG_NAMES))
def pkg(request):
    saved = Pkg(request.param).utils__faultinject.active()
    yield Pkg(request.param)
    fi = Pkg(request.param).utils__faultinject
    if saved is None:
        fi.uninstall()
    else:
        fi.install(saved)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _leader(p, clock, **kw):
    kw.setdefault("node_id", "L")
    kw.setdefault("lease_ttl_s", 10.0)
    return p.manager__replication.ReplicatedStateBackend(
        p.manager__state.MemoryBackend(), role="leader", clock=clock, **kw)


def _standby(p, clock, **kw):
    kw.setdefault("node_id", "F")
    kw.setdefault("lease_ttl_s", 10.0)
    return p.manager__replication.ReplicatedStateBackend(
        p.manager__state.MemoryBackend(), role="standby", clock=clock, **kw)


def _rest_for(p, backend, registry=None):
    server = p.manager__rest.ManagerRESTServer(
        registry if registry is not None else p.manager__registry.ModelRegistry(
            backend=backend),
        p.manager__cluster.ClusterManager(),
        state_backend=backend,
        ha=backend,
    )
    server.serve()
    return server


# ---------------------------------------------------------------------------
# Op log + leader commit path
# ---------------------------------------------------------------------------


class TestOpLog:
    def test_every_write_appends_term_seq_before_commit(self, pkg):
        b = _leader(pkg, _Clock())
        t = b.table("models")
        t.put("m1", {"id": "m1"})
        t.put_many({"m2": {"id": "m2"}, "m3": {"id": "m3"}})
        t.delete("m3")
        entries = b.log.entries_since(0)
        assert [(e["seq"], e["term"], e["op"]) for e in entries] == [
            (1, 1, "put_many"), (2, 1, "put_many"), (3, 1, "delete"),
        ]
        assert all(e["ns"] == "models" for e in entries)
        assert b.table("models").load_all() == {"m1": {"id": "m1"}, "m2": {"id": "m2"}}

    def test_failed_data_commit_discards_the_log_entry(self, pkg, tmp_path):
        rep, state, fi = pkg.manager__replication, pkg.manager__state, pkg.utils__faultinject
        db = str(tmp_path / "s.db")
        b = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        b.table("models").put("m1", {"id": "m1"})
        inj = fi.FaultInjector([fi.FaultSpec(site="state.put.models", kind="drop", at=(0,))])
        with fi.installed(inj):
            with pytest.raises(ConnectionError):
                b.table("models").put("m2", {"id": "m2"})
        assert [e["seq"] for e in b.log.entries_since(0)] == [1]
        b.table("models").put("m3", {"id": "m3"})
        follower = _standby(pkg, _Clock())
        follower.apply_ops(b.log.entries_since(0))
        assert follower.table("models").load_all() == {"m1": {"id": "m1"}, "m3": {"id": "m3"}}
        b.close()
        b2 = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        assert b2.table("models").load_all() == {"m1": {"id": "m1"}, "m3": {"id": "m3"}}, \
            "boot replay must not resurrect a write the caller saw fail"
        b2.close()

    def test_crash_between_append_and_commit_replays_at_boot(self, pkg, tmp_path):
        rep, state = pkg.manager__replication, pkg.manager__state
        db = str(tmp_path / "s.db")
        b = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        b.table("models").put("m1", {"id": "m1"})
        b.log.append({"term": b.term, "ns": "models", "op": "put_many",
                      "items": {"m2": {"id": "m2"}}})
        assert b.log.seq == 2
        b.close()
        b2 = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        assert b2.table("models").load_all() == {"m1": {"id": "m1"}, "m2": {"id": "m2"}}, \
            "boot replay must apply the logged-but-uncommitted tail"
        b2.close()

    def test_log_survives_restart_and_seq_continues(self, pkg, tmp_path):
        rep, state = pkg.manager__replication, pkg.manager__state
        db = str(tmp_path / "s.db")
        b = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        b.table("crud").put("a", {"v": 1})
        b.close()
        b2 = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        b2.table("crud").put("b", {"v": 2})
        assert [e["seq"] for e in b2.log.entries_since(0)] == [1, 2]
        b2.close()


# ---------------------------------------------------------------------------
# Follower application, snapshot bootstrap
# ---------------------------------------------------------------------------


class TestFollowerApply:
    def test_snapshot_then_incremental_tail(self, pkg):
        clock = _Clock()
        leader = _leader(pkg, clock)
        t = leader.table("models")
        t.put("m1", {"id": "m1"})
        t.put("gone", {"id": "gone"})
        t.delete("gone")
        follower = _standby(pkg, clock)
        with follower.applying():
            follower.table("models").put("stale", {"id": "stale"})
        follower.apply_snapshot(leader.snapshot())
        assert follower.table("models").load_all() == {"m1": {"id": "m1"}}
        assert follower.log.applied == leader.log.seq
        t.put("m2", {"id": "m2"})
        touched = follower.apply_ops(leader.log.entries_since(follower.log.applied))
        assert touched == {"models"}
        assert follower.table("models").get("m2") == {"id": "m2"}

    def test_apply_is_idempotent_and_skips_applied_seqs(self, pkg):
        clock = _Clock()
        leader = _leader(pkg, clock)
        leader.table("models").put("m1", {"id": "m1"})
        follower = _standby(pkg, clock)
        entries = leader.log.entries_since(0)
        follower.apply_ops(entries)
        follower.apply_ops(entries)
        assert follower.log.applied == 1
        assert follower.table("models").load_all() == {"m1": {"id": "m1"}}

    def test_replication_namespaces_never_ship_in_snapshots(self, pkg):
        leader = _leader(pkg, _Clock())
        leader.table("models").put("m1", {"id": "m1"})
        snap = leader.snapshot()
        assert "replication_log" not in snap["namespaces"]
        assert "replication_meta" not in snap["namespaces"]


# ---------------------------------------------------------------------------
# Lease, fencing, split brain
# ---------------------------------------------------------------------------


class TestLeaseAndFencing:
    def test_lease_signature_authenticates_leader_and_term(self, pkg):
        rep = pkg.manager__replication
        sig = rep.sign_lease("secret", "L", 3)
        lease = {"leader_id": "L", "term": 3, "sig": sig}
        assert rep.verify_lease("secret", lease)
        assert not rep.verify_lease("other-secret", lease)
        assert not rep.verify_lease("secret", dict(lease, term=4))
        assert not rep.verify_lease("secret", dict(lease, leader_id="evil"))

    def test_standby_rejects_writes(self, pkg):
        follower = _standby(pkg, _Clock())
        with pytest.raises(pkg.manager__replication.NotLeaderError):
            follower.table("models").put("x", {})

    def test_expired_lease_fences_the_leader(self, pkg):
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=5.0)
        leader.table("models").put("m1", {"id": "m1"})
        clock.t = 4.0
        leader.renew_lease()
        clock.t = 8.0
        leader.table("models").put("m2", {"id": "m2"})
        clock.t = 10.0
        with pytest.raises(pkg.manager__replication.NotLeaderError):
            leader.table("models").put("m3", {"id": "m3"})

    def test_renewing_an_expired_lease_steps_down_not_resurrects(self, pkg):
        NotLeaderError = pkg.manager__replication.NotLeaderError
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=5.0)
        leader.table("models").put("m1", {"id": "m1"})
        clock.t = 20.0
        with pytest.raises(NotLeaderError):
            leader.renew_lease()
        assert leader.role == "standby"
        with pytest.raises(NotLeaderError):
            leader.table("models").put("z", {"id": "z"})
        with pytest.raises(NotLeaderError):
            leader.renew_lease()

    def test_restarted_leader_defers_to_peer_with_higher_term(self, pkg):
        rep = pkg.manager__replication
        clock = _Clock()
        successor = _standby(pkg, clock, lease_ttl_s=30.0)
        successor.promote()
        rest = _rest_for(pkg, successor)
        try:
            term, url = rep.probe_peer_term([rest.url, "http://127.0.0.1:9"])
            assert (term, url) == (2, rest.url)
            old = _leader(pkg, clock, lease_ttl_s=30.0)
            if term > old.term:
                old.observe_term(term)
            assert old.role == "standby"
            with pytest.raises(rep.NotLeaderError):
                old.table("models").put("z", {"id": "z"})
        finally:
            rest.stop()

    def test_split_brain_old_leader_post_lease_write_rejected_by_term(self, pkg):
        rep = pkg.manager__replication
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=5.0)
        leader.table("models").put("m1", {"id": "m1"})
        follower = _standby(pkg, clock, lease_ttl_s=5.0)
        follower.apply_snapshot(leader.snapshot())
        clock.t = 10.0
        follower.promote()
        assert follower.role == "leader" and follower.term == 2
        follower.table("models").put("f1", {"id": "f1"})
        with pytest.raises(rep.NotLeaderError):
            leader.table("models").put("z", {"id": "z"})
        zombie_op = {"seq": follower.log.seq + 1, "term": 1, "ns": "models",
                     "op": "put_many", "items": {"z": {"id": "z"}}}
        with pytest.raises(rep.StaleTermError):
            follower.apply_ops([zombie_op])
        assert follower.table("models").get("z") is None
        leader.observe_term(follower.term)
        assert leader.role == "standby"
        with pytest.raises(rep.NotLeaderError):
            leader.renew_lease()

    def test_promotion_is_counted_and_roles_exported(self, pkg):
        MANAGER_ROLE = pkg.rpc__metrics.MANAGER_ROLE
        follower = _standby(pkg, _Clock())
        before_leader = MANAGER_ROLE.value(role="leader")
        follower.promote()
        assert follower.status()["failovers"] == 1
        assert MANAGER_ROLE.value(role="leader") == 1.0 >= before_leader


# ---------------------------------------------------------------------------
# LogFollower over the real REST surface
# ---------------------------------------------------------------------------


class TestFollowerOverREST:
    def test_tail_apply_health_and_lag(self, pkg):
        reg = pkg.manager__registry
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=30.0)
        registry = reg.ModelRegistry(reg.KVBlobStore(leader), backend=leader)
        rest = _rest_for(pkg, leader, registry)
        follower_backend = _standby(pkg, clock, lease_ttl_s=30.0)
        follower = pkg.manager__replication.LogFollower(
            follower_backend, rest.url, clock=clock, poll_interval_s=0.05)
        try:
            registry.create_model(name="m", type="mlp", scheduler_id="s",
                                  artifact=b"\x01" * 8)
            follower.poll_once()
            health = follower.health()
            assert health["applied_seq"] == health["leader_seq"] > 0
            assert health["lag_seconds"] == 0.0
            assert not follower.promoted
            reloaded = reg.ModelRegistry(reg.KVBlobStore(follower_backend),
                                         backend=follower_backend)
            m = reloaded.list(scheduler_id="s", name="m")[0]
            assert reloaded.load_artifact(m) == b"\x01" * 8
        finally:
            rest.stop()

    def test_replication_routes_and_standby_503(self, pkg):
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=30.0)
        rest = _rest_for(pkg, leader)
        try:
            with urllib.request.urlopen(rest.url + "/api/v1/replication:status",
                                        timeout=5) as r:
                status = json.loads(r.read())
            assert status["role"] == "leader"
            assert pkg.manager__replication.verify_lease(leader.lease_secret, status["lease"])
        finally:
            rest.stop()
        standby = _standby(pkg, clock)
        rest2 = _rest_for(pkg, standby)
        try:
            with urllib.request.urlopen(rest2.url + "/api/v1/healthy", timeout=5) as r:
                assert json.loads(r.read())["role"] == "standby"
            req = urllib.request.Request(
                rest2.url + "/api/v1/models", data=json.dumps({"name": "m"}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=5)
            assert err.value.code == 503
            assert err.value.headers.get("Retry-After") == "1"
        finally:
            rest2.stop()

    def test_lease_expiry_takeover_over_the_wire(self, pkg):
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=4.0)
        rest = _rest_for(pkg, leader)
        follower_backend = _standby(pkg, clock, lease_ttl_s=4.0)
        promoted = []
        follower = pkg.manager__replication.LogFollower(
            follower_backend, rest.url, clock=clock, on_promote=lambda: promoted.append(True))
        try:
            leader.table("models").put("m1", {"id": "m1"})
            follower.poll_once()
            assert follower.health()["lease_remaining_s"] > 0
        finally:
            rest.stop()
        follower.poll_once()
        assert not follower.promoted
        clock.t = 20.0
        follower.poll_once()
        assert follower.promoted and promoted == [True]
        assert follower_backend.role == "leader"
        assert follower_backend.term == 2
        assert follower_backend.table("models").get("m1") == {"id": "m1"}
        follower_backend.table("models").put("m2", {"id": "m2"})


# ---------------------------------------------------------------------------
# Replication-fetch auth
# ---------------------------------------------------------------------------


class TestReplicationAuth:
    def test_log_and_snapshot_refuse_unauthenticated_fetches(self, pkg):
        rep = pkg.manager__replication
        leader = _leader(pkg, _Clock(), lease_ttl_s=30.0)
        leader.table("users").put("root", {"password_hash": "h", "salt": "s"})
        rest = _rest_for(pkg, leader)
        try:
            for route in ("replication:snapshot", "replication:log"):
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(f"{rest.url}/api/v1/{route}", timeout=5)
                assert err.value.code == 403
                req = urllib.request.Request(
                    f"{rest.url}/api/v1/{route}",
                    headers={rep.REPLICATION_AUTH_HEADER: rep.sign_replication_request(
                        "not-the-secret", f"/api/v1/{route}")})
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(req, timeout=5)
                assert err.value.code == 403
        finally:
            rest.stop()

    def test_secret_holder_fetches_and_follower_sends_the_header(self, pkg):
        rep = pkg.manager__replication
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=30.0)
        leader.table("crud").put("m1", {"id": "m1"})
        rest = _rest_for(pkg, leader)
        try:
            path = "/api/v1/replication:log"
            req = urllib.request.Request(
                rest.url + path + "?from_seq=0",
                headers={rep.REPLICATION_AUTH_HEADER: rep.sign_replication_request(
                    leader.lease_secret, path)})
            with urllib.request.urlopen(req, timeout=5) as r:
                payload = json.loads(r.read())
            assert [e["seq"] for e in payload["entries"]] == [1]
            follower = _standby(pkg, clock, lease_ttl_s=30.0)
            rep.LogFollower(follower, rest.url, clock=clock).poll_once()
            assert follower.table("crud").get("m1") == {"id": "m1"}
        finally:
            rest.stop()

    def test_ha_config_refuses_the_default_lease_secret(self, pkg):
        schema = pkg.config__schema
        sig = inspect.signature(pkg.manager__replication.ReplicatedStateBackend.__init__)
        assert sig.parameters["lease_secret"].default == schema.DEFAULT_LEASE_SECRET
        schema.HASection().validate()
        with pytest.raises(schema.ConfigError):
            schema.HASection(enable=True).validate()
        with pytest.raises(schema.ConfigError):
            schema.HASection(replicate_from="http://leader:1").validate()
        with pytest.raises(schema.ConfigError):
            schema.HASection(enable=True, lease_secret="short").validate()
        schema.HASection(enable=True, lease_secret="x" * 16).validate()


# ---------------------------------------------------------------------------
# Log compaction
# ---------------------------------------------------------------------------


class TestLogCompaction:
    def test_leader_truncates_below_the_retention_window(self, pkg):
        leader = _leader(pkg, _Clock(), lease_ttl_s=3600.0)
        leader.COMPACT_EVERY = 8
        leader.RETAIN_OPS = 8
        t = leader.table("models")
        for i in range(40):
            t.put(f"m{i}", {"id": f"m{i}"})
        entries = leader.log.entries_since(0)
        assert len(entries) <= 8 + leader.COMPACT_EVERY
        assert leader.log.floor > 1
        assert entries[0]["seq"] == leader.log.floor
        assert len(t.load_all()) == 40

    def test_truncation_never_eats_the_unapplied_tail(self, pkg, tmp_path):
        rep, state = pkg.manager__replication, pkg.manager__state
        db = str(tmp_path / "s.db")
        b = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        b.table("models").put("m1", {"id": "m1"})
        b.log.append({"term": b.term, "ns": "models", "op": "put_many",
                      "items": {"m2": {"id": "m2"}}})
        b.log.truncate_below(10_000)
        assert [e["seq"] for e in b.log.pending()] == [2]
        b.close()
        b2 = rep.ReplicatedStateBackend(state.SQLiteBackend(db), node_id="L")
        assert b2.table("models").get("m2") == {"id": "m2"}
        b2.close()

    def test_sqlite_range_scan_matches_the_base_filter(self, pkg, tmp_path):
        state = pkg.manager__state
        sql = state.SQLiteBackend(str(tmp_path / "s.db")).table("ns")
        mem = state.MemoryBackend().table("ns")
        for t in (sql, mem):
            for i in range(10):
                t.put(f"{i:020d}", {"i": i})
        assert sql.load_range(f"{4:020d}") == mem.load_range(f"{4:020d}")
        sql.delete_range(f"{3:020d}")
        mem.delete_range(f"{3:020d}")
        assert sql.load_all() == mem.load_all()
        assert sorted(sql.load_all()) == [f"{i:020d}" for i in range(3, 10)]

    def test_follower_behind_the_floor_rebootstraps_via_snapshot(self, pkg):
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=3600.0)
        leader.COMPACT_EVERY = 4
        leader.RETAIN_OPS = 4
        rest = _rest_for(pkg, leader)
        follower_backend = _standby(pkg, clock, lease_ttl_s=3600.0)
        follower = pkg.manager__replication.LogFollower(follower_backend, rest.url, clock=clock)
        try:
            leader.table("crud").put("m0", {"id": "m0"})
            follower.poll_once()
            assert follower_backend.log.applied == leader.log.seq
            for i in range(1, 30):
                leader.table("crud").put(f"m{i}", {"id": f"m{i}"})
            assert leader.log.floor > follower_backend.log.applied + 1
            follower.poll_once()
            assert follower_backend.log.applied == leader.log.seq
            assert len(follower_backend.table("crud").load_all()) == 30
            assert follower.lag_seconds() == 0.0
        finally:
            rest.stop()


# ---------------------------------------------------------------------------
# Client failover: ManagerEndpoints
# ---------------------------------------------------------------------------


def _http_error(code, base="http://x"):
    return urllib.error.HTTPError(base, code, "standby", {}, io.BytesIO(b"{}"))


class TestManagerEndpoints:
    def test_parses_comma_spec_and_is_sticky(self, pkg):
        eps = pkg.rpc__resolver.ManagerEndpoints("http://a:1, http://b:2")
        assert eps.all() == ["http://a:1", "http://b:2"]
        calls = []

        def fn(base):
            calls.append(base)
            if base == "http://a:1":
                raise ConnectionError("down")
            return "ok"

        assert eps.call(fn) == "ok"
        assert calls == ["http://a:1", "http://b:2"]
        assert eps.call(fn) == "ok"
        assert calls[-1] == "http://b:2"

    def test_503_fails_over_but_404_propagates(self, pkg):
        eps = pkg.rpc__resolver.ManagerEndpoints(["http://a:1", "http://b:2"])
        seen = []

        def standby_then_ok(base):
            seen.append(base)
            if base == "http://a:1":
                raise _http_error(503)
            return "leader"

        assert eps.call(standby_then_ok) == "leader"
        assert seen == ["http://a:1", "http://b:2"]

        def not_found(base):
            raise _http_error(404, base)

        with pytest.raises(urllib.error.HTTPError):
            eps.call(not_found)

    def test_all_down_raises_last_error_and_counts_failovers(self, pkg):
        counter = pkg.rpc__metrics.MANAGER_ENDPOINT_FAILOVERS_TOTAL
        eps = pkg.rpc__resolver.ManagerEndpoints("http://a:1,http://b:2", client="t-all-down")
        before = counter.value(client="t-all-down")

        def dead(base):
            raise ConnectionError(base)

        with pytest.raises(ConnectionError):
            eps.call(dead)
        assert counter.value(client="t-all-down") == before + 2

    def test_shared_instance_moves_every_client(self, pkg):
        eps = pkg.rpc__resolver.ManagerEndpoints("http://a:1,http://b:2")
        jobs = pkg.jobs__remote.RemoteJobClient(eps)
        rollout = pkg.rollout__client.RolloutRESTClient(eps)
        assert jobs.endpoints is rollout.endpoints is eps
        eps.failover("http://a:1")
        assert jobs.base == rollout.base_url == "http://b:2"


# ---------------------------------------------------------------------------
# Jittered backoff
# ---------------------------------------------------------------------------


class TestDecorrelatedJitterBackoff:
    def test_seeded_schedule_is_reproducible(self, pkg):
        B = pkg.rpc__retry.DecorrelatedJitterBackoff
        a = B(base=1.0, cap=30.0, rng=random.Random(7))
        b = B(base=1.0, cap=30.0, rng=random.Random(7))
        assert [a.next() for _ in range(8)] == [b.next() for _ in range(8)]

    def test_spread_grows_decorrelated_and_capped(self, pkg):
        B = pkg.rpc__retry.DecorrelatedJitterBackoff
        bo = B(base=1.0, cap=10.0, rng=random.Random(3))
        seq = [bo.next() for _ in range(64)]
        assert all(1.0 <= v <= 10.0 for v in seq)
        assert len({round(v, 6) for v in seq}) > 32, "no spread = herd"
        other = B(base=1.0, cap=10.0, rng=random.Random(4))
        assert [other.next() for _ in range(8)] != seq[:8]

    def test_reset_returns_to_base_envelope(self, pkg):
        bo = pkg.rpc__retry.DecorrelatedJitterBackoff(base=1.0, cap=60.0, rng=random.Random(5))
        for _ in range(10):
            bo.next()
        bo.reset()
        assert bo.next() <= 3.0

    def test_cluster_client_and_dynconfig_take_seeded_rngs(self, pkg):
        Client = pkg.rpc__cluster_client.RemoteClusterClient
        Dynconfig = pkg.manager__dynconfig.Dynconfig
        c1 = Client("http://m:1", backoff_rng=random.Random(11), keepalive_interval_s=20.0)
        c2 = Client("http://m:1", backoff_rng=random.Random(11), keepalive_interval_s=20.0)
        assert [c1._backoff.next() for _ in range(5)] == [c2._backoff.next() for _ in range(5)]

        def failing():
            raise ConnectionError("manager down")

        d1 = Dynconfig(failing, refresh_interval=60.0, backoff_rng=random.Random(12))
        d2 = Dynconfig(failing, refresh_interval=60.0, backoff_rng=random.Random(12))
        assert d1.refresh() is False and d1.last_refresh_ok is False
        assert d2.refresh() is False
        assert [d1._backoff.next() for _ in range(5)] == [d2._backoff.next() for _ in range(5)]


# ---------------------------------------------------------------------------
# SQLite hardening
# ---------------------------------------------------------------------------


class TestSQLiteHardening:
    def test_busy_timeout_and_wal_set_at_open(self, pkg, tmp_path):
        b = pkg.manager__state.SQLiteBackend(str(tmp_path / "s.db"))
        assert b._conn.execute("PRAGMA busy_timeout").fetchone()[0] == 5000
        assert b._conn.execute("PRAGMA journal_mode").fetchone()[0].lower() == "wal"
        b.close()

    def test_close_is_idempotent(self, pkg, tmp_path):
        b = pkg.manager__state.SQLiteBackend(str(tmp_path / "s.db"))
        b.close()
        b.close()

    def test_migration_commits_all_namespaces_in_one_transaction(self, pkg, tmp_path):
        import sqlite3

        state, fi = pkg.manager__state, pkg.utils__faultinject
        models_db = str(tmp_path / "manager.db")
        conn = sqlite3.connect(models_db)
        conn.execute("CREATE TABLE models (id TEXT PRIMARY KEY, name TEXT, type TEXT,"
                     " version INTEGER, scheduler_id TEXT, state TEXT, evaluation "
                     "TEXT, blob_key TEXT, created_at REAL, updated_at REAL)")
        conn.execute("INSERT INTO models VALUES ('m1','r','mlp',1,'s','active',"
                     "'{}','b',1.0,2.0)")
        conn.commit()
        conn.close()
        crud_db = str(tmp_path / "crud.db")
        conn = sqlite3.connect(crud_db)
        conn.execute("CREATE TABLE crud_rows (kind TEXT, id TEXT, value TEXT, "
                     "PRIMARY KEY (kind, id))")
        conn.execute("INSERT INTO crud_rows VALUES ('application','a1','{\"id\": \"a1\"}')")
        conn.commit()
        conn.close()
        backend = state.SQLiteBackend(str(tmp_path / "state.db"))
        inj = fi.FaultInjector([fi.FaultSpec(site="state.put.crud", kind="drop", at=(0,))])
        with fi.installed(inj):
            with pytest.raises(ConnectionError):
                state.migrate_legacy_sqlite(backend, models_db=models_db, crud_db=crud_db)
        assert backend.table("models").load_all() == {}
        assert backend.table("crud").load_all() == {}
        counts = state.migrate_legacy_sqlite(backend, models_db=models_db, crud_db=crud_db)
        assert counts == {"models": 1, "crud": 1}
        assert state.migrate_legacy_sqlite(backend, models_db=models_db, crud_db=crud_db) == {}
        backend.close()


# ---------------------------------------------------------------------------
# Circuit-breaker visibility
# ---------------------------------------------------------------------------


class TestBreakerVisibility:
    def test_state_gauge_tracks_transitions(self, pkg):
        gauge = pkg.rpc__metrics.CIRCUIT_BREAKER_STATE
        clock = _Clock()
        br = pkg.rpc__retry.CircuitBreaker(failure_threshold=2, reset_timeout_s=1.0,
                                           clock=clock, name="parent-9")
        assert gauge.value(target="parent-9") == 0.0
        br.record_failure()
        br.record_failure()
        assert gauge.value(target="parent-9") == 2.0
        clock.t = 2.0
        assert br.allow()
        assert gauge.value(target="parent-9") == 1.0
        br.record_success()
        assert gauge.value(target="parent-9") == 0.0

    def test_transitions_log_once_not_per_call(self, pkg, caplog):
        br = pkg.rpc__retry.CircuitBreaker(failure_threshold=1, reset_timeout_s=10.0,
                                           clock=_Clock(), name="parent-log")
        with caplog.at_level(logging.INFO, logger=f"{pkg.root}.rpc.retry"):
            br.record_failure()
            for _ in range(50):
                br.record_failure()
                br.allow()
        opens = [r for r in caplog.records if "parent-log" in r.getMessage()]
        assert len(opens) == 1 and opens[0].levelno == logging.WARNING

    def test_unnamed_breaker_stays_silent(self, pkg, caplog):
        br = pkg.rpc__retry.CircuitBreaker(failure_threshold=1)
        with caplog.at_level(logging.INFO, logger=f"{pkg.root}.rpc.retry"):
            br.record_failure()
        assert not caplog.records


# ---------------------------------------------------------------------------
# Metrics schema
# ---------------------------------------------------------------------------


class TestMetricsSchema:
    def test_ha_metric_names_and_labels(self, pkg):
        m = pkg.rpc__metrics
        assert m.MANAGER_ROLE.name == "manager_role"
        assert m.MANAGER_ROLE.label_names == ("role",)
        assert m.REPLICATION_LAG.name == "manager_replication_lag_seconds"
        assert m.REPLICATION_LAG.label_names == ()
        assert m.MANAGER_FAILOVERS_TOTAL.name == "manager_failovers_total"
        assert m.MANAGER_FAILOVERS_TOTAL.label_names == ("node",)
        assert m.MANAGER_ENDPOINT_FAILOVERS_TOTAL.name == "manager_endpoint_failovers_total"
        assert m.MANAGER_ENDPOINT_FAILOVERS_TOTAL.label_names == ("client",)
        assert m.CIRCUIT_BREAKER_STATE.name == "rpc_circuit_breaker_state"
        assert m.CIRCUIT_BREAKER_STATE.label_names == ("target",)
        assert m.REPLICATION_COMMIT_SECONDS.name == "manager_replication_commit_seconds"

    def test_exposition_renders_the_ha_plane(self, pkg):
        m = pkg.rpc__metrics
        m.MANAGER_ROLE.set(1.0, role="leader")
        m.REPLICATION_LAG.set(0.25)
        m.MANAGER_FAILOVERS_TOTAL.inc(node="mgr-test")
        text = pkg.utils__metrics.default_registry.expose_text()
        assert 'manager_role{role="leader"} 1.0' in text
        assert "manager_replication_lag_seconds 0.25" in text
        assert 'manager_failovers_total{node="mgr-test"}' in text


# ---------------------------------------------------------------------------
# Zero-pinning subscriber failover (in-process half of the drill)
# ---------------------------------------------------------------------------


def _mlp_artifact(p, seed=0):
    dim = p.records__features.DOWNLOAD_FEATURE_DIM
    rng = np.random.default_rng(seed)
    weights = [(rng.standard_normal((dim, 1)).astype(np.float32),
                np.zeros(1, dtype=np.float32))]
    export = p.trainer__export
    return export.scorer_to_bytes(export.MLPScorer(weights=weights))


class TestSubscriberFailover:
    def test_model_poll_fails_over_with_zero_pinning(self, pkg):
        reg, sched = pkg.manager__registry, pkg.scheduler
        artifact = _mlp_artifact(pkg)
        clock = _Clock()
        leader = _leader(pkg, clock, lease_ttl_s=60.0)
        registry = reg.ModelRegistry(reg.KVBlobStore(leader), backend=leader)
        rest = _rest_for(pkg, leader, registry)
        model = registry.create_model(name="parent-bandwidth-mlp", type="mlp",
                                      scheduler_id="s1", artifact=artifact)
        registry.activate(model.id)
        follower_backend = _standby(pkg, clock, lease_ttl_s=60.0)
        pkg.manager__replication.LogFollower(follower_backend, rest.url,
                                             clock=clock).poll_once()
        standby_registry = reg.ModelRegistry(reg.KVBlobStore(follower_backend),
                                             backend=follower_backend)
        standby_rest = pkg.manager__rest.ManagerRESTServer(
            standby_registry, pkg.manager__cluster.ClusterManager(),
            state_backend=follower_backend, ha=follower_backend)
        standby_rest.serve()
        remote = pkg.rpc__registry_client.RemoteRegistry(f"{rest.url},{standby_rest.url}")
        subscriber = sched.ModelSubscriber(remote, sched.MLEvaluator(), scheduler_id="s1")
        try:
            assert subscriber.refresh() is True
            assert subscriber.pinned is False
            rest.stop()
            assert subscriber.refresh() is False
            assert subscriber.pinned is False, \
                "poll pinned despite a live standby — failover is broken"
            assert remote.base_url == standby_rest.url
        finally:
            standby_rest.stop()


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


J, T = Pkg("jax"), Pkg("torch")


def test_signatures_are_equal_bytes_across_packages():
    rng = np.random.default_rng(5)
    for _ in range(16):
        secret = bytes(rng.integers(33, 127, int(rng.integers(16, 48)))).decode()
        node = f"mgr-{int(rng.integers(1e6))}"
        term = int(rng.integers(1, 1000))
        path = f"/api/v1/replication:{['log', 'snapshot', 'status'][int(rng.integers(3))]}"
        for fn in ("sign_lease", "sign_replication_request"):
            args = (secret, node, term) if fn == "sign_lease" else (secret, path)
            assert getattr(J.manager__replication, fn)(*args) == \
                getattr(T.manager__replication, fn)(*args)
        lease = T.manager__replication.ReplicatedStateBackend(
            T.manager__state.MemoryBackend(), node_id=node, lease_secret=secret).lease_payload()
        assert J.manager__replication.verify_lease(secret, lease)
    assert J.manager__replication.REPLICATION_AUTH_HEADER == \
        T.manager__replication.REPLICATION_AUTH_HEADER
    assert J.config__schema.DEFAULT_LEASE_SECRET == T.config__schema.DEFAULT_LEASE_SECRET


def _fill(p, backend, seed):
    reg = p.manager__registry
    registry = reg.ModelRegistry(reg.KVBlobStore(backend), backend=backend)
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(3):
        m = registry.create_model(name="mlp-a", type="mlp", scheduler_id="s1",
                                  artifact=rng.bytes(256), evaluation={"mae": 0.1 * i})
        ids.append(m.id)
    registry.activate(ids[1])
    crud = backend.table("crud")
    crud.put_many({f"k{i}": {"v": float(rng.standard_normal())} for i in range(8)})
    crud.delete("k3")
    return registry, ids


def _data_rows(backend):
    return {ns: backend.table(ns).load_all() for ns in backend.namespaces()
            if ns not in ("replication_log", "replication_meta")}


@pytest.mark.parametrize("leader_pkg,follower_pkg", [("jax", "torch"), ("torch", "jax")])
def test_follower_tails_the_other_packages_leader(leader_pkg, follower_pkg):
    """A follower of one package bootstraps from and tails a leader of the
    other over REST, then promotes when the leader dies, with the same data
    rows, watermark and the artifact readable."""
    L, F = Pkg(leader_pkg), Pkg(follower_pkg)
    clock = _Clock()
    leader = _leader(L, clock, lease_ttl_s=5.0, lease_secret="s" * 24)
    leader.table("crud").put("pre", {"v": 0})
    registry, ids = _fill(L, leader, 0)
    rest = _rest_for(L, leader, registry)
    follower_backend = _standby(F, clock, lease_ttl_s=5.0, lease_secret="s" * 24)
    follower = F.manager__replication.LogFollower(follower_backend, rest.url, clock=clock)
    try:
        follower.poll_once()
        assert follower.health()["applied_seq"] == leader.log.seq
        # More writes after the bootstrap arrive as log entries.
        more, _ = _fill(L, leader, 1)
        follower.poll_once()
        assert follower_backend.log.applied == leader.log.seq
        assert _data_rows(follower_backend) == _data_rows(leader)
        assert follower_backend.log.entries_since(0)[-1] == leader.log.entries_since(0)[-1]
    finally:
        rest.stop()
    clock.t = 60.0
    follower.poll_once()
    assert follower.promoted and follower_backend.term == 2
    reg = F.manager__registry
    mine = reg.ModelRegistry(reg.KVBlobStore(follower_backend), backend=follower_backend)
    assert mine.load_artifact(mine.get(ids[2])) == registry.load_artifact(registry.get(ids[2]))


def test_port_leaders_database_opens_in_the_reference(tmp_path):
    """A replicated SQLite file a port leader wrote, with a crash-pending
    tail, opens in the reference: the same rows, the same log, and the
    tail replayed at boot."""
    db = str(tmp_path / "manager-state.db")
    b = T.manager__replication.ReplicatedStateBackend(T.manager__state.SQLiteBackend(db),
                                                      node_id="L")
    registry, ids = _fill(T, b, 2)
    b.log.append({"term": b.term, "ns": "crud", "op": "put_many",
                  "items": {"pending": {"v": 9}}})
    rows, log = _data_rows(b), b.log.entries_since(0, limit=10_000)
    blob = registry.load_artifact(registry.get(ids[0]))
    b.close()
    j = J.manager__replication.ReplicatedStateBackend(J.manager__state.SQLiteBackend(db),
                                                      node_id="L")
    try:
        assert j.log.entries_since(0, limit=10_000) == log
        rows["crud"]["pending"] = {"v": 9}
        assert _data_rows(j) == rows
        assert j.log.applied == j.log.seq == len(log)
        reg = J.manager__registry
        jr = reg.ModelRegistry(reg.KVBlobStore(j), backend=j)
        assert jr.active_model("s1", "mlp-a").id == ids[1]
        assert jr.load_artifact(jr.get(ids[0])) == blob
        j.table("crud").put("after", {"v": 1})
        assert j.log.seq == len(log) + 1
    finally:
        j.close()
