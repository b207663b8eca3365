"""Port parity: the tenant QoS plane, ``dragonfly2_tpu_torch/qos/`` and
the batcher's weighted-fair lanes, against ``dragonfly2_tpu/qos/`` and
``dragonfly2_tpu/scheduler/microbatch.py`` (the counterpart of
``TestTenantPolicy``, ``TestTenantAccounting``, ``TestDRRWeightedFair``,
``TestAutopilot`` and ``TestServiceQoSWiring`` in ``tests/test_qos.py``).

- Policy payloads round-trip equal; bad payloads raise alike.
- ``TenantAccounting`` verdicts and snapshots are equal on one seeded
  operation stream with an injected clock.
- ``SLOAutopilot`` decisions, levels and what it applies are equal on one
  seeded journal stream, live and replayed; the admission object is one
  duck-typed recorder in both packages.
- The port's ``ScorerBatcher._drain_locked`` yields exactly the JAX
  drains (request ids per drain) for the same enqueue sequences: the
  100 : 1 flood, FIFO mixes, a single lane, no policy, a policy that
  raises, refills between drains and seeded random mixes.
- ``on_qos_config`` installs the policy in the service and its batcher,
  and the announce answer carries ``tenant_qos`` as the reference's does.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np
import pytest

import dragonfly2_tpu.qos as jqos
import dragonfly2_tpu.scheduler.microbatch as jmb
import dragonfly2_tpu_torch.qos as tqos
import dragonfly2_tpu_torch.scheduler.microbatch as tmb

PKGS = {"jax": (jqos, jmb), "torch": (tqos, tmb)}

POLICY = {
    "t-gold": {"tenant_class": "gold", "weight": 4.0, "announce_qps": 50.0,
               "announce_burst": 5, "priority": 1},
    "t-silver": {"tenant_class": "silver", "weight": 2.0, "announce_qps": 20.0},
    "t-bronze": {"tenant_class": "bronze", "weight": 1.0, "upload_rate_bytes_s": 1e6},
}


def test_policy_payload_round_trips_equal():
    j = jqos.QoSPolicy.from_payload(POLICY)
    t = tqos.QoSPolicy.from_payload(POLICY)
    assert t.to_payload() == j.to_payload()
    assert tqos.QoSPolicy.from_payload(t.to_payload()).to_payload() == t.to_payload()
    for tenant in list(POLICY) + ["unknown", "", "default"]:
        assert t.for_tenant(tenant).to_dict() == j.for_tenant(tenant).to_dict()
        assert t.weight_of(tenant) == j.weight_of(tenant)
        assert t.class_of(tenant) == j.class_of(tenant)
    rng = np.random.default_rng(0)
    chars = list("abcXYZ09 ._-/@!é")
    for _ in range(200):
        subject = "".join(rng.choice(chars, size=int(rng.integers(0, 12))))
        assert tqos.derive_tenant(subject) == jqos.derive_tenant(subject)


@pytest.mark.parametrize("raw", [
    "nonsense", {"t": "x"}, {"t": {"weight": -1}}, {"t": {"tenant_class": "platinum"}},
    {"t": {"priority": 7}}, {"t": {"announce_qps": -1}}, {"t": {"announce_burst": -1}},
    {"t": {"bogus": 1}},
])
def test_bad_payloads_raise_alike(raw):
    messages = []
    for qos in (jqos, tqos):
        with pytest.raises(ValueError) as exc:
            qos.parse_tenant_qos(raw)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def _accounting_run(qos, seed=0):
    """One seeded stream of accounting operations; → every verdict and
    signal read along the way, and the final snapshot."""
    rng = np.random.default_rng(seed)
    acct = qos.TenantAccounting(qos.QoSPolicy.from_payload(POLICY), window_s=2.0, now=0.0)
    tenants = ["t-gold", "t-silver", "t-bronze", "t-other", ""]
    out = []
    t = 0.0
    for i in range(3000):
        t += float(rng.exponential(0.004))
        tenant = tenants[int(rng.choice(5, p=[0.15, 0.5, 0.2, 0.1, 0.05]))]
        out.append(acct.note_at(tenant, t))
        if i % 97 == 0:
            acct.record_shed(tenant)
            acct.record_bytes(tenant, int(rng.integers(1, 1 << 20)))
        if i % 250 == 0:
            out.append([(acct.over_quota(x), acct.noise_factor(x), acct.class_of(x))
                        for x in tenants])
        if i == 1000:
            acct.set_cap_factor(0.25)
        if i == 2000:
            acct.set_policy(qos.QoSPolicy.from_payload({"t-silver": {"weight": 8.0}}))
    return out, acct.snapshot(), acct.cap_factor()


def test_accounting_decisions_equal_on_one_seeded_stream():
    j = _accounting_run(jqos)
    t = _accounting_run(tqos)
    assert t == j
    verdicts = [v for v in t[0] if isinstance(v, bool)]
    assert 0 < verdicts.count(False) < len(verdicts)


class _Admission:
    """The duck-typed admission object both autopilots drive."""

    def __init__(self):
        self.biases = []

    def set_shed_bias(self, bias):
        self.biases.append(bias)


AP_SLO = {"name": "ap", "objective": "latency", "metric": "ap_lat_seconds",
          "threshold_ms": 10.0, "target": 0.9, "fast_window_s": 3.0,
          "slow_window_s": 12.0, "burn_threshold": 2.0}


def _journal_stream(seed=4, n=80):
    """Cumulative journal snapshots of a sketch through healthy,
    overloaded and recovered phases (built with the port's registry; the
    snapshot is plain JSON)."""
    from dragonfly2_tpu_torch.utils.metrics import Registry

    rng = np.random.default_rng(seed)
    reg = Registry()
    lat = reg.sketch("ap_lat_seconds", "latency")
    snaps = []
    for i in range(n):
        bad = 0.7 if 25 <= i < 40 else 0.01
        for _ in range(10):
            lat.observe(0.05 if rng.random() < bad else 0.002)
        snaps.append({"service": "s", "run_id": "r", "seq": i + 1, "ts": 100.0 + i,
                      "metrics": reg.snapshot()})
    return snaps


def test_autopilot_decisions_equal_live_and_replayed():
    snaps = _journal_stream()
    got = {}
    for name, (qos, _mb) in PKGS.items():
        admission = _Admission()
        acct = qos.TenantAccounting(qos.QoSPolicy.from_payload(POLICY))
        pilot = qos.SLOAutopilot([AP_SLO], admission=admission, accounting=acct,
                                 shed_bias_step=0.25, cap_backoff=0.5, relax_after=3)
        levels = [pilot.ingest(s) for s in snaps]
        replayed = qos.SLOAutopilot.replay(snaps, [AP_SLO], relax_after=3)
        assert replayed.decisions == pilot.decisions
        got[name] = (pilot.decisions, levels, admission.biases, acct.cap_factor())
        pilot.close()
        replayed.close()
    assert got["torch"] == got["jax"]
    levels = got["torch"][1]
    assert max(levels) >= 2 and levels[-1] == 0
    # The hysteresis walk of tests/test_qos.py, step by step.
    pilot = tqos.SLOAutopilot([AP_SLO], relax_after=3, max_level=4)
    assert [pilot._step(True, float(i)) for i in range(6)] == [1, 2, 3, 4, 4, 4]
    assert [pilot._step(False, 10.0 + i) for i in range(7)] == [4, 4, 3, 3, 3, 2, 2]
    assert pilot._step(True, 20.0) == 3
    pilot.close()


# ---------------------------------------------------------------------------
# the DRR drain, request by request
# ---------------------------------------------------------------------------


def _enqueue(mb, b, tenant, rows, tag):
    req = mb._Request(np.full((rows, 2), tag, dtype=np.float32), None, None, tenant=tenant)
    lane = b._lanes.get(req.tenant)
    if lane is None:
        lane = b._lanes[req.tenant] = deque()
    lane.append(req)
    b._pending_rows += req.rows


class _RaisingPolicy:
    def weight_of(self, tenant):
        if tenant == "bad":
            raise RuntimeError("broken policy row")
        return 3.0


def _drains(pkg, policy_payload, script, max_batch_rows, quantum=None):
    """Run an enqueue/drain script through one package's batcher; → the
    request tags of every drain, in order."""
    qos, mb = PKGS[pkg]
    if policy_payload == "raising":
        policy = _RaisingPolicy()
    else:
        policy = qos.QoSPolicy.from_payload(policy_payload) if policy_payload else None
    kwargs = {} if quantum is None else {"drr_quantum": quantum}
    b = mb.ScorerBatcher(max_batch_rows=max_batch_rows, qos_policy=policy, **kwargs)
    out = []
    for op in script:
        if op[0] == "enq":
            _enqueue(mb, b, *op[1:])
        else:
            for _ in range(op[1]):
                batch = b._drain_locked()
                if not batch:
                    break
                out.append([float(r.features[0, 0]) for r in batch])
    while b._pending_rows > 0:
        out.append([float(r.features[0, 0]) for r in b._drain_locked()])
    assert not b._lanes
    return out


def _flood_script():
    rng = np.random.default_rng(0)
    script = [("enq", "flood", int(rng.integers(4, 16)), i) for i in range(200)]
    script += [("enq", "small", 8, 1000 + i) for i in range(20)]
    return script


def _random_script(seed):
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "c", "d", ""]
    script, tag = [], 0
    for _ in range(12):
        for _ in range(int(rng.integers(0, 40))):
            script.append(("enq", tenants[int(rng.integers(0, 5))],
                           int(rng.integers(1, 24)), tag))
            tag += 1
        script.append(("drain", int(rng.integers(1, 4))))
    return script


CASES = {
    "flood_100_to_1": ({"flood": {"weight": 100.0}, "small": {"weight": 1.0}},
                       _flood_script(), 256),
    "fifo_3_to_1": ({"x": {"weight": 3.0}, "y": {"weight": 1.0}},
                    [("enq", "x" if i % 5 < 3 else "y", 1 + i % 8, i) for i in range(120)], 64),
    "single_lane": ({"only": {"weight": 2.0}},
                    [("enq", "only", 1 + i % 6, i) for i in range(40)], 4096),
    "heavy_light": ({"heavy": {"weight": 3.0}, "light": {"weight": 1.0}},
                    [("enq", t, 8, i) for i in range(300) for t in ("heavy", "light")], 128),
    "no_policy": (None, _random_script(5), 96),
    "raising_policy": ("raising", [("enq", t, 5, i) for i in range(60)
                                   for t in ("bad", "good")], 40),
    "refills": (POLICY, [("enq", t, 6, i) for i in range(30)
                         for t in ("t-gold", "t-silver", "t-bronze")]
                + [("drain", 2)] + [("enq", "t-bronze", 4, 500 + i) for i in range(40)]
                + [("drain", 1)] + [("enq", "t-new", 9, 900 + i) for i in range(10)], 100),
    **{f"random_{s}": (POLICY if s % 2 else {"a": {"weight": 5.0}, "c": {"weight": 0.5}},
                       _random_script(s), int(32 + 40 * s)) for s in range(6)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_drr_drains_equal_the_jax_batchers(case):
    policy, script, cap = CASES[case]
    j = _drains("jax", policy, script, cap)
    t = _drains("torch", policy, script, cap)
    assert t == j
    served = sorted(x for drain in t for x in drain)
    assert served == sorted(float(op[3]) for op in script if op[0] == "enq")
    if case == "flood_100_to_1":
        # Every drain while the 1-weight lane is backlogged serves it.
        small_done = 0
        for drain in t:
            small = sum(x >= 1000 for x in drain)
            if small_done < 20:
                assert small >= 1
            small_done += small
    if case == "single_lane":
        assert t == [list(map(float, range(40)))]


def test_drr_drains_equal_with_a_small_quantum():
    policy, script, cap = CASES["random_3"]
    assert _drains("torch", policy, script, cap, quantum=3) == _drains(
        "jax", policy, script, cap, quantum=3)


def test_weighted_threaded_flushes_return_each_callers_scores():
    class SumScorer:
        wants_features = True

        def score(self, feats, src_buckets=None, dst_buckets=None):
            return feats.sum(axis=1)

    b = tmb.ScorerBatcher(SumScorer(), linger_s=0.002,
                          qos_policy=tqos.QoSPolicy.from_payload(POLICY))
    errors = []

    def worker(tenant, tag):
        rng = np.random.default_rng(tag)
        for _ in range(30):
            f = np.full((int(rng.integers(1, 6)), 2), float(tag), dtype=np.float32)
            if not np.array_equal(b.score(f, tenant=tenant), f.sum(axis=1)):
                errors.append((tenant, tag))

    threads = [threading.Thread(target=worker, args=(t, i), daemon=True)
               for i, t in enumerate(["t-gold", "t-silver", "t-bronze", "t-silver"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors and b._pending_rows == 0 and not any(th.is_alive() for th in threads)


# ---------------------------------------------------------------------------
# service and wire
# ---------------------------------------------------------------------------


def _ml_service(pkg):
    if pkg == "jax":
        from dragonfly2_tpu.scheduler import (
            HostFeatureCache, MLEvaluator, Resource, SchedulerService, Scheduling,
            SchedulingConfig, ScorerBatcher)
    else:
        from dragonfly2_tpu_torch.scheduler import (
            HostFeatureCache, MLEvaluator, Resource, SchedulerService, Scheduling,
            SchedulingConfig, ScorerBatcher)
    ev = MLEvaluator(feature_cache=HostFeatureCache(max_hosts=256), batcher=ScorerBatcher())
    return SchedulerService(Resource(), Scheduling(ev, SchedulingConfig(retry_interval=0)))


def _host(pkg, i):
    if pkg == "jax":
        from dragonfly2_tpu.scheduler.resource import Host
    else:
        from dragonfly2_tpu_torch.scheduler.resource import Host
    return Host(id=f"qh-{i}", hostname=f"qh-{i}", ip=f"10.8.0.{i}", port=8002,
                download_port=8001)


def test_on_qos_config_installs_in_service_and_batcher():
    service = _ml_service("torch")
    batcher = service.scheduling.evaluator.batcher
    service.on_qos_config({"tenant_qos": {"t-a": {"weight": -1}}})
    service.on_qos_config({"tenant_qos": "nonsense"})
    service.on_qos_config({})
    assert service.qos_policy is None and batcher._qos_policy is None
    assert batcher._weight("t-a") == 1.0
    service.on_qos_config({"tenant_qos": POLICY})
    assert service.qos_policy is not None
    assert batcher._qos_policy is service.qos_policy
    assert [batcher._weight(t) for t in ("t-gold", "t-silver", "t-bronze", "x")] == [
        4.0, 2.0, 1.0, 1.0]
    service.set_qos_policy(None)
    assert batcher._qos_policy is None


def test_announce_answer_carries_tenant_qos_as_the_reference():
    from dragonfly2_tpu.rpc.scheduler_server import SchedulerRPCAdapter as JAdapter
    from dragonfly2_tpu.rpc.scheduler_server import host_to_wire as j_wire
    from dragonfly2_tpu_torch.rpc.scheduler_server import SchedulerRPCAdapter as TAdapter
    from dragonfly2_tpu_torch.rpc.scheduler_server import host_to_wire as t_wire

    answers = {}
    for pkg, adapter_cls, wire in (("jax", JAdapter, j_wire), ("torch", TAdapter, t_wire)):
        service = _ml_service(pkg)
        adapter = adapter_cls(service)
        before = adapter.announce_host({"host": wire(_host(pkg, 1)), "tenant": "t-gold"})
        service.on_qos_config({"tenant_qos": POLICY})
        after = adapter.announce_host({"host": wire(_host(pkg, 2)), "tenant": "t-gold"})
        out = adapter.register_peer({"host_id": "qh-2", "url": "https://o/x",
                                     "tenant": "t-bronze"})
        tenant = service.resource.peer_manager.load(out["peer_id"]).tenant
        answers[pkg] = (before, after, tenant)
    assert "tenant_qos" not in answers["torch"][0]
    assert answers["torch"][1]["tenant_qos"] == jqos.QoSPolicy.from_payload(POLICY).to_payload()
    assert answers["torch"] == answers["jax"]
