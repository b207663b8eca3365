"""Port parity for the scheduler's ML parent-ranking path as a whole.

The same seeded swarm and the same candidate sets go through the JAX
package's ``MLEvaluator(FusedMLPScorer)`` (its jnp path, as it serves off
a TPU) and the port's (its plain K1 on the CPU): featurization and
``HostFeatureCache.serve`` are byte-equal, parent orderings equal,
scores within 2e-5.  Then both packages' ``build``-made services run the
warm-then-register sequence of ``chip_smoke.py`` at 2 tasks × 40 hosts,
with the JAX side's global ``random`` and the port's ``random.Random``
seeded identically before every request: both choose the same parents.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from dragonfly2_tpu.cli.scheduler import build as jax_build
from dragonfly2_tpu.config import SchedulerConfigFile
from dragonfly2_tpu.ops.pallas_score import FusedMLPScorer as JaxFusedMLPScorer
from dragonfly2_tpu.records.synthetic import SyntheticCluster as JaxCluster
from dragonfly2_tpu.scheduler import Evaluator as JaxEvaluator
from dragonfly2_tpu.scheduler import HostFeatureCache as JaxCache
from dragonfly2_tpu.scheduler import MLEvaluator as JaxMLEvaluator
from dragonfly2_tpu.scheduler import ScheduleResultKind as JaxKind
from dragonfly2_tpu.sim.swarm import build_announce_swarm as jax_swarm
from dragonfly2_tpu.sim.swarm import host_from_latent as jax_host_from_latent
from dragonfly2_tpu.trainer.export import load_scorer as jax_load_scorer
from dragonfly2_tpu_torch.cli.scheduler import ConfigError, SchedulerConfig, build
from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
from dragonfly2_tpu_torch.records.synthetic import PIECE_SIZE, SyntheticCluster
from dragonfly2_tpu_torch.scheduler import (
    Evaluator,
    HostFeatureCache,
    MLEvaluator,
    ScheduleResultKind,
)
from dragonfly2_tpu_torch.sim.swarm import build_announce_swarm, host_from_latent
from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes


def _weights(seed=3, dims=(32, 64, 64, 1)):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]


def _draws(n_peers, n_draws=12, size=14, seed=11):
    rng = np.random.default_rng(seed)
    for _ in range(n_draws):
        ci = int(rng.integers(0, n_peers))
        cand = [int(c) if c < ci else int(c) + 1
                for c in rng.choice(n_peers - 1, size=size, replace=False)]
        yield ci, cand


def test_evaluator_rankings_and_featurization_match_jax():
    weights = _weights()
    jtask, jpeers = jax_swarm(120, seed=3)
    jcache = JaxCache(max_hosts=512)
    jfused = JaxFusedMLPScorer(jcache, weights, use_pallas=False)
    jml = JaxMLEvaluator(jfused, feature_cache=jcache)
    task, peers = build_announce_swarm(120, seed=3)
    cache = HostFeatureCache(max_hosts=512)
    fused = FusedMLPScorer(cache, weights, device="cpu")
    ml = MLEvaluator(fused, feature_cache=cache)
    for ci, cand in _draws(len(peers)):
        jparents = [jpeers[c] for c in cand]
        parents = [peers[c] for c in cand]
        # serve: every array of the gather, byte-equal.
        jsv = jcache.serve(jpeers[ci].host, [p.host for p in jparents])
        sv = cache.serve(peers[ci].host, [p.host for p in parents])
        assert jsv._fields == sv._fields
        for name, a, b in zip(sv._fields, jsv, sv):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
        # Featurization, both forms, byte-equal.
        ja = jml._featurize_batch(jparents, jpeers[ci])
        a = ml._featurize_batch(parents, peers[ci])
        for x, y in zip(ja, a):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        js = jml._featurize_slots(jparents, jpeers[ci])
        s = ml._featurize_slots(parents, peers[ci])
        for x, y in zip(js, s):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        # Scores and orderings.
        edge, slots, cslot, _, _ = s
        dst = np.full(len(slots), cslot, dtype=np.int64)
        np.testing.assert_allclose(
            fused.score(edge, src_buckets=slots, dst_buckets=dst),
            jfused.score(edge, src_buckets=slots, dst_buckets=dst),
            rtol=2e-5, atol=2e-5,
        )
        want = [p.id for p in jml.evaluate_parents(jparents, jpeers[ci], jtask.total_piece_count)]
        got = [p.id for p in ml.evaluate_parents(parents, peers[ci], task.total_piece_count)]
        assert got == want
    assert ml.degrades == 0


def test_rule_evaluator_matches_jax_and_its_scalar_oracle():
    """The rule ranking the ML evaluator degrades to (and the ``default``
    algorithm serves): columnar scores bit-equal to the JAX package's,
    orderings equal to the port's own scalar oracle."""
    jtask, jpeers = jax_swarm(120, seed=5)
    task, peers = build_announce_swarm(120, seed=5)
    jev = JaxEvaluator(feature_cache=JaxCache(max_hosts=512))
    ev = Evaluator(feature_cache=HostFeatureCache(max_hosts=512))
    for ci, cand in _draws(len(peers), seed=12):
        jparents = [jpeers[c] for c in cand]
        parents = [peers[c] for c in cand]
        total = task.total_piece_count
        assert np.array_equal(ev.evaluate_all(parents, peers[ci], total),
                              jev.evaluate_all(jparents, jpeers[ci], total))
        got = [p.id for p in ev.evaluate_parents(parents, peers[ci], total)]
        assert got == [p.id for p in jev.evaluate_parents(jparents, jpeers[ci], total)]
        assert got == [p.id for p in ev.evaluate_parents_reference(parents, peers[ci], total)]


N_TASKS, HOSTS_PER_TASK, PIECES, MEASURED = 2, 40, 16, 8


def _services(tmp_path, blob):
    """Both packages' services from their ``build``, algorithm ml,
    retries without sleeping, the same scorer blob installed."""
    jcfg = SchedulerConfigFile()
    jcfg.storage.dir = str(tmp_path / "records")
    jcfg.network_topology.enable = False
    jcfg.scheduling.algorithm = "ml"
    jcfg.scheduling.retry_interval_s = 0.0
    jsvc, jstorage, _ = jax_build(jcfg)
    # The port's seed trigger is None-only: the reference side matches it
    # (its remote trigger would dial the synthetic seed hosts).
    jsvc.seed_peer_trigger = None
    jev = jsvc.scheduling.evaluator
    jev.set_scorer(
        JaxFusedMLPScorer.from_scorer(jev.feature_cache, jax_load_scorer(blob),
                                      use_pallas=False)
    )
    cfg = SchedulerConfig()
    cfg.storage.dir = str(tmp_path / "port-records")
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.retry_interval_s = 0.0
    svc = build(cfg, device="cpu", scorer_blob=blob, rng=random.Random())
    return (jsvc, jstorage), svc


def _finish(svc, cluster, index, res, kind_parents, hi):
    """Task length, every piece from the first scheduled parent or the
    source, finished (the chip_smoke warm-up download)."""
    peer = res.peer
    svc.set_task_info(peer, PIECES * PIECE_SIZE, PIECES, PIECE_SIZE)
    sched = res.schedule
    parent = sched.parents[0] if sched is not None and sched.kind is kind_parents else None
    for n in range(PIECES):
        if parent is None:
            bw, pid = float(cluster.down_cap[hi]) * 0.5, ""
        else:
            bw = max(cluster.bandwidth(index[parent.host.id], hi, noise=False), 1e3)
            pid = parent.id
        svc.report_piece_finished(peer, n, parent_id=pid, length=PIECE_SIZE,
                                  cost_ns=int(PIECE_SIZE / bw * 1e9))
    svc.report_peer_finished(peer)


def _outcome(res):
    sched = res.schedule
    if sched is None:
        return ("NONE", [])
    return (sched.kind.name, [p.id for p in sched.parents])


def test_build_made_services_choose_the_same_parents(tmp_path):
    blob = scorer_to_bytes(MLPScorer(weights=_weights(0)))
    (jsvc, jstorage), svc = _services(tmp_path, blob)
    n_hosts = N_TASKS * HOSTS_PER_TASK
    jcluster = JaxCluster(num_hosts=n_hosts, seed=0)
    cluster = SyntheticCluster(num_hosts=n_hosts, seed=0)
    jhosts = [jax_host_from_latent(lh) for lh in jcluster.hosts]
    hosts = [host_from_latent(lh) for lh in cluster.hosts]
    assert [h.id for h in jhosts] == [h.id for h in hosts]
    for jh, h in zip(jhosts, hosts):
        jsvc.announce_host(jh)
        svc.announce_host(h)
    jindex = {h.id: i for i, h in enumerate(jhosts)}
    index = {h.id: i for i, h in enumerate(hosts)}
    urls = [f"https://origin.example.com/blob/{t}" for t in range(N_TASKS)]

    def register(seed, hi, url, peer_id):
        random.seed(seed)
        svc.scheduling.rng.seed(seed)
        jres = jsvc.register_peer(host=jhosts[hi], url=url, peer_id=peer_id)
        res = svc.register_peer(host=hosts[hi], url=url, peer_id=peer_id)
        assert _outcome(res) == _outcome(jres), peer_id
        return jres, res

    scored = 0
    for t in range(N_TASKS):
        for k in range(HOSTS_PER_TASK):
            hi = t * HOSTS_PER_TASK + k
            jres, res = register(1000 + hi, hi, urls[t], f"warm-{t}-{k}")
            _finish(jsvc, jcluster, jindex, jres, JaxKind.PARENTS, hi)
            _finish(svc, cluster, index, res, ScheduleResultKind.PARENTS, hi)
            scored += res.schedule.kind is ScheduleResultKind.PARENTS
    assert scored >= N_TASKS * (HOSTS_PER_TASK - 1)
    # Registrations into a task where the host has no peer yet.
    for q in range(N_TASKS * MEASURED):
        t = q % N_TASKS
        hi = ((t + 1) % N_TASKS) * HOSTS_PER_TASK + q // N_TASKS
        jres, res = register(5000 + q, hi, urls[t], f"req-{q}")
        assert res.schedule.kind is ScheduleResultKind.PARENTS
    ev = svc.scheduling.evaluator
    assert ev.degrades == 0 and ev.batcher.fallbacks == 0
    assert ev.batcher.scorer_calls > 0
    jstorage.flush()


def test_build_validates_and_refuses_cuda_without_a_card(monkeypatch):
    import torch

    cfg = SchedulerConfig()
    cfg.scheduling.algorithm = "bogus"
    with pytest.raises(ConfigError):
        build(cfg, device="cpu")
    with pytest.raises(ConfigError):
        build(SchedulerConfig(), device="cpu",
              scorer_blob=scorer_to_bytes(MLPScorer(weights=_weights())))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        build(SchedulerConfig())
    svc = build(SchedulerConfig(), device="cpu")
    assert type(svc.scheduling.evaluator).__name__ == "Evaluator"
    assert svc.scheduling.config.filter_parent_limit == 15
    assert svc.scheduling.config.candidate_parent_limit == 4
    assert svc.scheduling.config.retry_interval == 0.5
    assert svc.scheduling.evaluator.feature_cache.max_hosts == 65536
