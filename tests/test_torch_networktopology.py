"""Port parity: the probe store and the ``nt`` evaluator,
``dragonfly2_tpu_torch/scheduler/networktopology.py`` and
``NetworkTopologyEvaluator`` / ``new_evaluator`` in
``dragonfly2_tpu_torch/scheduler/evaluator.py``, against
``dragonfly2_tpu/scheduler/networktopology.py`` and
``dragonfly2_tpu/scheduler/evaluator.py``; and ``cli/scheduler.build``
with ``scheduling.algorithm: nt``.

The JAX store draws probe targets from the process-global ``random``, the
port's from the ``random.Random`` it is given: both are seeded alike.
Probes carry fixed creation times, so the stores compare exactly.

Tolerances, stated: EMA RTTs, counts, arrays and records exactly (the
same float64 fold and the same int truncation); scores within 1e-12
(the same float64 expression); orderings exactly.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

from dragonfly2_tpu.cli.scheduler import build as jax_build
from dragonfly2_tpu.config import SchedulerConfigFile as JaxSchedulerConfig
from dragonfly2_tpu.records import schema as jschema
from dragonfly2_tpu.records.synthetic import SyntheticCluster as JaxCluster
from dragonfly2_tpu.scheduler import evaluator as jev
from dragonfly2_tpu.scheduler import networktopology as jnt
from dragonfly2_tpu.scheduler.resource import HostManager as JaxHostManager
from dragonfly2_tpu.sim.swarm import build_announce_swarm as jax_announce_swarm
from dragonfly2_tpu.sim.swarm import host_from_latent as jax_host_from_latent
from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
from dragonfly2_tpu_torch.records import schema
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.scheduler import evaluator as tev
from dragonfly2_tpu_torch.scheduler import networktopology as tnt
from dragonfly2_tpu_torch.scheduler.resource import HostManager
from dragonfly2_tpu_torch.sim.swarm import build_announce_swarm, host_from_latent

SCORE_TOL = 1e-12
N_HOSTS = 40


def _hosts(n=N_HOSTS, seed=3):
    jc, tc = JaxCluster(num_hosts=n, seed=seed), SyntheticCluster(num_hosts=n, seed=seed)
    jhosts = [jax_host_from_latent(lh) for lh in jc.hosts]
    thosts = [host_from_latent(lh) for lh in tc.hosts]
    assert [h.id for h in jhosts] == [h.id for h in thosts]
    return jhosts, thosts


def _stores(cfg_kw=None, seed=17):
    """Both stores over host managers holding the same hosts."""
    jhosts, thosts = _hosts()
    jhm, thm = JaxHostManager(), HostManager()
    for jh, th in zip(jhosts, thosts):
        jhm.store(jh.id, jh)
        thm.store(th.id, th)
    kw = cfg_kw or {}
    random.seed(seed)
    j = jnt.NetworkTopology(jhm, jnt.TopologyConfig(**kw))
    t = tnt.NetworkTopology(thm, tnt.TopologyConfig(**kw), rng=random.Random(seed))
    return j, t, [h.id for h in thosts]


def _probes(ids, n=400, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s, d = rng.choice(len(ids), 2, replace=False)
        out.append((ids[s], ids[d], int(rng.integers(1_000, 900_000_000)), 1_000.0 + i))
    return out


def _feed(store, probe_cls, probes):
    for src, dst, rtt, at in probes:
        store.store(src, dst)
        store.enqueue_probe(src, dst, probe_cls(host_id=dst, rtt_ns=rtt, created_at=at))


@pytest.mark.parametrize("queue", [1, 3, 5])
def test_ema_queue_caps_and_probed_counts_equal(queue):
    j, t, ids = _stores({"probe_queue_length": queue})
    probes = _probes(ids[:8], n=300)        # few hosts: every edge queues many probes
    _feed(j, jnt.Probe, probes)
    _feed(t, tnt.Probe, probes)
    assert t.edge_count() == j.edge_count() > 0
    for src in ids[:8]:
        assert t.neighbours(src) == j.neighbours(src)
        for dst in ids[:8]:
            assert t.average_rtt(src, dst) == j.average_rtt(src, dst)
            assert [(p.host_id, p.rtt_ns) for p in t.probes(src, dst)] == [
                (p.host_id, p.rtt_ns) for p in j.probes(src, dst)]
            assert len(t.probes(src, dst)) <= queue
        assert t.probed_count(src) == j.probed_count(src)
    # The fold, by hand, on one edge: avg = 0.1 * avg + 0.9 * rtt.
    src, dst = probes[-1][0], probes[-1][1]
    avg = None
    for p in t.probes(src, dst):
        avg = float(p.rtt_ns) if avg is None else avg * 0.1 + p.rtt_ns * 0.9
    assert t.average_rtt(src, dst) == int(avg)


def test_find_probed_hosts_draws_as_the_jax_package():
    j, t, ids = _stores({"probe_count": 5}, seed=23)
    _feed(j, jnt.Probe, _probes(ids))
    _feed(t, tnt.Probe, _probes(ids))
    random.seed(99)
    t.rng.seed(99)
    for src in ids[:20]:
        jp = [h.id for h in j.find_probed_hosts(src)]
        tp = [h.id for h in t.find_probed_hosts(src)]
        assert tp == jp and len(tp) == 5 and src not in tp
    assert all(t.probed_count(h) == j.probed_count(h) for h in ids)
    assert tnt.NetworkTopology().find_probed_hosts(ids[0]) == []


def _state(store) -> dict:
    """``export_state`` without the edges' creation times (wall clock)."""
    state = store.export_state()
    for e in state["edges"]:
        e.pop("created_at")
    return state


def _strip(rec: dict) -> dict:
    """A snapshot record without its id and times."""
    rec = dict(rec)
    rec.pop("id")
    rec.pop("created_at")
    for th in [rec["host"]] + rec["dest_hosts"]:
        th["probes"].pop("created_at")
        th["probes"].pop("updated_at")
    return rec


def test_snapshot_records_equal_apart_from_ids_and_times():
    j, t, ids = _stores()
    probes = _probes(ids)
    _feed(j, jnt.Probe, probes)
    _feed(t, tnt.Probe, probes)
    t.store("lonely-a", "lonely-b")         # an edge with no probe: not snapshotted
    j.store("lonely-a", "lonely-b")
    jr, tr = j.snapshot(), t.snapshot()
    assert len(tr) == len(jr) > 0
    assert all(len(r.dest_hosts) <= schema.MAX_DEST_HOSTS for r in tr)
    assert [_strip(schema.to_dict(r)) for r in tr] == [_strip(jschema.to_dict(r)) for r in jr]
    host = tr[0].host
    assert host.hostname and host.ip and host.network.idc   # host metadata filled in


def test_state_save_load_and_corrupt_file(tmp_path):
    j, t, ids = _stores()
    probes = _probes(ids)
    _feed(j, jnt.Probe, probes)
    _feed(t, tnt.Probe, probes)
    assert _state(t) == _state(j)
    path = tmp_path / "topology_state.json"
    t.save(str(path))
    assert json.loads(path.read_text()) == t.export_state()
    fresh_t = tnt.NetworkTopology()
    fresh_j = jnt.NetworkTopology()
    assert fresh_t.load(str(path)) == fresh_j.load(str(path)) == t.edge_count()
    assert fresh_t.export_state() == fresh_j.export_state() == t.export_state()
    # A saved JAX state loads in the port.
    j.save(str(tmp_path / "jax_state.json"))
    assert tnt.NetworkTopology().load(str(tmp_path / "jax_state.json")) == j.edge_count()
    for bad in ("{not json", "[1, 2]", '{"edges": [{"dst": "x"}]}', ""):
        path.write_text(bad)
        assert tnt.NetworkTopology().load(str(path)) == 0
        assert jnt.NetworkTopology().load(str(path)) == 0
    assert tnt.NetworkTopology().load(str(tmp_path / "absent.json")) == 0


def test_merge_remote_edges_newest_wins_and_edge_arrays_equal():
    j, t, ids = _stores()
    probes = _probes(ids)
    _feed(j, jnt.Probe, probes)
    _feed(t, tnt.Probe, probes)
    edges = t.export_edges()
    assert edges == j.export_edges()
    src, dst = edges[0]["src"], edges[0]["dst"]
    remote = [
        {"src": src, "dst": dst, "average_rtt_ns": 5, "updated_at": 1.0},        # stale
        {"src": ids[1], "dst": ids[2], "average_rtt_ns": 7, "updated_at": 9e9},  # newer
        {"src": "new-a", "dst": "new-b", "average_rtt_ns": 11, "updated_at": 2.0},
        {"src": "", "dst": "x", "average_rtt_ns": 1},                           # malformed
        {"src": "a", "dst": "b"},                                                # no rtt
    ]
    assert t.merge_remote_edges(remote) == j.merge_remote_edges(remote) == 2
    assert t.average_rtt(src, dst) == edges[0]["average_rtt_ns"]
    assert t.average_rtt(ids[1], ids[2]) == 7 and t.average_rtt("new-a", "new-b") == 11
    assert t.probed_count("new-b") == 0
    jids, js, jd, jr = j.to_edge_arrays()
    tids, ts, td, tr = t.to_edge_arrays()
    assert tids == jids
    for a, b in ((ts, js), (td, jd), (tr, jr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    t.delete_host(ids[1])
    j.delete_host(ids[1])
    assert _state(t) == _state(j)
    assert all(ids[1] not in (e["src"], e["dst"]) for e in t.export_edges())


def _announce_pair(seed=2):
    jtask, jpeers = jax_announce_swarm(N_HOSTS, seed=seed)
    task, peers = build_announce_swarm(N_HOSTS, seed=seed)
    return (jtask, jpeers), (task, peers)


def _rtt_probes(peers, seed=8):
    """Parent → child probes over many host pairs (and none for others)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(len(peers)):
        for c in rng.choice(len(peers), 12, replace=False):
            if c != p:
                out.append((peers[p].host.id, peers[c].host.id,
                            int(rng.integers(100_000, 950_000_000)), 50.0))
    return out


def test_nt_evaluator_scores_and_orderings_equal():
    (jtask, jpeers), (task, peers) = _announce_pair()
    j, t = jnt.NetworkTopology(), tnt.NetworkTopology()
    probes = _rtt_probes(peers)
    _feed(j, jnt.Probe, probes)
    _feed(t, tnt.Probe, probes)
    jeval, teval = jev.NetworkTopologyEvaluator(j), tev.NetworkTopologyEvaluator(t)
    assert teval.ALGORITHM == "nt" and teval.feature_cache is None
    rng = np.random.default_rng(4)
    for _ in range(20):
        ci = int(rng.integers(0, N_HOSTS))
        cand = [int(x) for x in rng.choice(N_HOSTS, 10, replace=False) if x != ci]
        parents, jparents = [peers[i] for i in cand], [jpeers[i] for i in cand]
        want = np.array([jeval.evaluate(p, jpeers[ci], 16) for p in jparents])
        got = np.array([teval.evaluate(p, peers[ci], 16) for p in parents])
        assert np.abs(got - want).max() <= SCORE_TOL
        assert np.abs(teval.evaluate_all(parents, peers[ci], 16) - want).max() <= SCORE_TOL
        order = [p.id for p in teval.evaluate_parents(parents, peers[ci], 16)]
        assert order == [p.id for p in jeval.evaluate_parents(jparents, jpeers[ci], 16)]
        assert order == [p.id for p in teval.evaluate_parents_reference(parents, peers[ci], 16)]
    assert isinstance(tev.new_evaluator("nt", networktopology=t), tev.NetworkTopologyEvaluator)
    assert type(tev.new_evaluator("nt")) is tev.Evaluator


def test_build_with_nt_ranks_as_the_jax_build(tmp_path):
    """The ``nt`` fault: the port's ``build`` served the rule evaluator for
    ``scheduling.algorithm: nt`` and ranked without the RTT term."""
    jcfg = JaxSchedulerConfig()
    jcfg.storage.dir = str(tmp_path / "jax-records")
    jcfg.scheduling.algorithm = "nt"
    jsvc, _, _ = jax_build(jcfg)
    cfg = SchedulerConfig()
    cfg.storage.dir = str(tmp_path / "records")
    cfg.scheduling.algorithm = "nt"
    svc = build(cfg, device="cpu", rng=random.Random(0))
    ev = svc.scheduling.evaluator
    assert isinstance(ev, tev.NetworkTopologyEvaluator)
    assert svc.networktopology is not None and svc.storage is not None
    assert svc.storage.directory == cfg.storage.dir

    (jtask, jpeers), (task, peers) = _announce_pair(seed=6)
    for jp, p in zip(jpeers, peers):
        jsvc.announce_host(jp.host)
        svc.announce_host(p.host)
    by_src = {}
    for src, dst, rtt, _ in _rtt_probes(peers, seed=9):
        by_src.setdefault(src, []).append((dst, rtt))
    for jp, p in zip(jpeers, peers):
        jsvc.sync_probes_finished(jp.host, by_src.get(p.host.id, []))
        svc.sync_probes_finished(p.host, by_src.get(p.host.id, []))
    rule = tev.Evaluator()
    rng = np.random.default_rng(12)
    differs = 0
    for _ in range(30):
        ci = int(rng.integers(0, N_HOSTS))
        cand = [int(x) for x in rng.choice(N_HOSTS, 12, replace=False) if x != ci]
        parents, jparents = [peers[i] for i in cand], [jpeers[i] for i in cand]
        order = [p.id for p in ev.evaluate_parents(parents, peers[ci], 16)]
        jorder = [p.id for p in jsvc.scheduling.evaluator.evaluate_parents(
            jparents, jpeers[ci], 16)]
        assert order == jorder
        differs += order != [p.id for p in rule.evaluate_parents(parents, peers[ci], 16)]
    assert differs > 0        # the RTT term reorders candidates the rules rank alike


def test_build_without_the_probe_store_serves_the_rules(tmp_path):
    cfg = SchedulerConfig()
    cfg.storage.dir = str(tmp_path / "records")
    cfg.scheduling.algorithm = "nt"
    cfg.network_topology.enable = False
    svc = build(cfg, device="cpu")
    assert type(svc.scheduling.evaluator) is tev.Evaluator
    assert svc.networktopology is None
    _, thosts = _hosts()
    assert svc.sync_probes_start(thosts[0]) == []


def test_service_probe_sync_and_leave_host(tmp_path):
    cfg = SchedulerConfig()
    cfg.storage.dir = str(tmp_path / "records")
    svc = build(cfg, device="cpu", rng=random.Random(1))
    _, thosts = _hosts()
    for h in thosts:
        svc.announce_host(h)
    targets = svc.sync_probes_start(thosts[0])
    assert len(targets) == 5 and thosts[0].id not in [h.id for h in targets]
    svc.sync_probes_finished(thosts[0], [(h.id, 1_000_000 * (i + 1)) for i, h in enumerate(targets)])
    nt = svc.networktopology
    assert nt.average_rtt(thosts[0].id, targets[2].id) == 3_000_000
    svc.leave_host(targets[2])
    assert not nt.has(thosts[0].id, targets[2].id)
    assert nt.edge_count() == 4
