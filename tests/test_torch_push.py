"""The push-reschedule path on the CPU: ``scheduler/push.py`` and the
service's server-push triggers against the JAX package's.

One seeded swarm (2 tasks, 4 finished seeds and 8 children each) runs
through both packages' schedulers, with the ``default`` rule evaluator
and with ``ml`` over the same 32→64→64→1 blob (the port's
``FusedMLPScorer`` on ``device="cpu"``, so K1's plain version; the JAX
package's numpy ``MLPScorer``, as its subscription installs).  One
``random.Random`` seeds the port's ``Scheduling`` and the JAX package's
global ``random`` alike.  Two of every three children subscribe to a
``PeerStreamHub``.  Held equal across the packages:

- bad-parent ejection through ``report_piece_finished``: the pushed
  children, in order, and each push's parents, in rank order;
- the stall sweep's count (``reschedule_stalled``) and its pushes;
- the cooldown: a second sweep inside it pushes nothing;
- a child that is not subscribed keeps its edges.

A planted fault in the port (the hub claims children that never
subscribed) must make the comparison fail.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import dragonfly2_tpu.cli.scheduler as j_cli
import dragonfly2_tpu.config as j_config
import dragonfly2_tpu.scheduler.push as j_push
import dragonfly2_tpu.scheduler.resource as j_resource
import dragonfly2_tpu.trainer.export as j_export
import dragonfly2_tpu_torch.cli.scheduler as t_cli
import dragonfly2_tpu_torch.config as t_config
import dragonfly2_tpu_torch.scheduler.push as t_push
import dragonfly2_tpu_torch.scheduler.resource as t_resource
from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
from dragonfly2_tpu_torch.scheduler import metrics as t_metrics
from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes

SEED = 16
# 4 + 8 peers a task: under filter_parent_limit (15), every candidate is
# ranked, so the sample's shuffle cannot change a schedule.
TASKS, SEEDS, CHILDREN = 2, 4, 8
MS = 1_000_000


def seeded_blob(seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    dims = (32, 64, 64, 1)
    weights = [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
                rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
               for i in range(len(dims) - 1)]
    return scorer_to_bytes(MLPScorer(weights=weights))


def _service(pkg, algorithm, tmp_path):
    """Either package's scheduler at its defaults, as its ``build`` makes it
    (no retry sleep: the seeds' first registers find no parent)."""
    if pkg == "port":
        cfg = t_config.SchedulerConfigFile()
        cfg.scheduling.algorithm = algorithm
        cfg.scheduling.retry_interval_s = 0.0
        cfg.storage.dir = str(tmp_path / "port")
        return t_cli.build(cfg, device="cpu", rng=random.Random(SEED), seed_trigger=False,
                           scorer_blob=seeded_blob() if algorithm == "ml" else None)
    random.seed(SEED)
    cfg = j_config.SchedulerConfigFile()
    cfg.scheduling.algorithm = algorithm
    cfg.scheduling.retry_interval_s = 0.0
    cfg.storage.dir = str(tmp_path / "jax")
    service, _storage, runner = j_cli.build(cfg)
    service.seed_peer_trigger = None
    if algorithm == "ml":
        service.scheduling.evaluator.set_scorer(j_export.load_scorer(seeded_blob()))
    return service


def _hosts(resource_mod):
    r = np.random.default_rng(SEED)
    hosts = []
    for i in range(TASKS * (SEEDS + CHILDREN)):
        h = resource_mod.Host(id=f"push-h{i}", hostname=f"push-h{i}", ip=f"10.16.0.{i}",
                              port=8002, download_port=8001)
        h.stats.network.idc = f"idc-{i % 2}"
        h.stats.network.location = f"r{i % 3}|z1|rk1"
        h.stats.cpu.percent = float(r.uniform(0, 100))
        h.stats.memory.used_percent = float(r.uniform(0, 100))
        h.upload_count = int(r.integers(0, 40))
        hosts.append(h)
    return hosts


def _children_by_id(load_children):
    def ordered(self, peer_id):
        return sorted(load_children(self, peer_id), key=lambda p: p.id)
    return ordered


def run_swarm(pkg, algorithm, tmp_path, monkeypatch):
    """→ a summary of every push and DAG outcome, by host and peer ids.

    The reference walks a parent's children in the order of a set of
    vertices, and each push moves DAG edges the next one's candidate
    filter reads; both packages walk them by peer id here, so the two
    runs make the same schedules in the same order."""
    resource_mod = t_resource if pkg == "port" else j_resource
    monkeypatch.setattr(resource_mod.Task, "load_children",
                        _children_by_id(resource_mod.Task.load_children))
    service = _service(pkg, algorithm, tmp_path)
    push_mod = t_push if pkg == "port" else j_push
    hub = push_mod.PeerStreamHub(push_cooldown_s=0.0)
    service.hub = hub
    hosts = _hosts(resource_mod)
    for h in hosts:
        service.announce_host(h)
    pushes = []
    subscribed, unsubscribed, callbacks = {}, {}, {}
    children_by_task = []
    for t in range(TASKS):
        url = f"https://origin.example/push-{t}"
        base = t * (SEEDS + CHILDREN)
        for i in range(SEEDS):
            reg = service.register_peer(host=hosts[base + i], url=url, peer_id=f"s{t}-{i}")
            service.set_task_info(reg.peer, content_length=40 << 20, total_piece_count=10,
                                  piece_size=4 << 20)
            for n in range(10):
                service.report_piece_finished(reg.peer, n, length=4 << 20,
                                              cost_ns=(10 + i + n) * MS)
            service.report_peer_finished(reg.peer)
        children = []
        for i in range(CHILDREN):
            reg = service.register_peer(host=hosts[base + SEEDS + i], url=url,
                                        peer_id=f"c{t}-{i}")
            assert reg.schedule is not None
            child = reg.peer
            children.append(child)
            table = subscribed if i % 3 != 2 else unsubscribed
            table[child.id] = sorted(p.host.id for p in child.task.load_parents(child.id))
            if i % 3 != 2:
                callbacks[child.id] = (lambda res, cid=child.id: pushes.append(
                    ("push", cid, [p.host.id for p in res.parents])))
                hub.register(child.id, callbacks[child.id])
        children_by_task.append(children)
    # Bad-parent ejection: per task, the seed with the most children gets
    # piece costs past the reference's rule (last > 20 × mean) from one of
    # its children.
    ejected = []
    for children in children_by_task:
        task = children[0].task
        counts = {}
        for c in children:
            for p in task.load_parents(c.id):
                counts[p.id] = counts.get(p.id, 0) + 1
        bad_id = sorted(counts, key=lambda k: (-counts[k], k))[0]
        reporter = next(c for c in children
                        if bad_id in [p.id for p in task.load_parents(c.id)])
        before = {c.id: [p.id for p in task.load_parents(c.id)] for c in children}
        bad_host = service.resource.peer_manager.load(bad_id).host.id
        pushes.append(("eject", bad_id, bad_host))
        for n, cost in enumerate((10 * MS, 11 * MS, 900 * MS)):
            service.report_piece_finished(reporter, 10 + n, parent_id=bad_id,
                                          length=4 << 20, cost_ns=cost)
        after = {c.id: [p.id for p in task.load_parents(c.id)] for c in children}
        ejected.append({
            "bad": bad_id,
            "bad_node": service.scheduling.evaluator.is_bad_node(
                service.resource.peer_manager.load(bad_id)),
            "children_of_bad": sorted(c for c, ps in before.items() if bad_id in ps),
            "still_on_bad": sorted(c for c, ps in after.items() if bad_id in ps),
            "kept": {c: after[c] == before[c] for c in before if c in unsubscribed},
        })
    # Stall sweep: every child idle for a minute.
    pushes.append(("stall",))
    for children in children_by_task:
        for c in children:
            c.updated_at -= 60
    stalled = service.reschedule_stalled(max_idle_s=5)
    again = service.reschedule_stalled(max_idle_s=5)
    # The cooldown: on a fresh hub with the same subscriptions, the first
    # sweep pushes and the next one inside the cooldown pushes nothing.
    pushes.append(("cooldown",))
    hub = push_mod.PeerStreamHub(push_cooldown_s=60.0)
    for cid, send in callbacks.items():
        hub.register(cid, send)
    service.hub = hub
    for children in children_by_task:
        for c in children:
            c.updated_at -= 120
    damped_first = service.reschedule_stalled(max_idle_s=5)
    for children in children_by_task:
        for c in children:
            c.updated_at -= 120
    damped_second = service.reschedule_stalled(max_idle_s=5)
    # Each phase's pushes as (child, parents in rank order), by child.
    phases, current = [], None
    for p in pushes:
        if p[0] in ("eject", "stall", "cooldown"):
            current = [p, []]
            phases.append(current)
        else:
            current[1].append((p[1], tuple(p[2])))
    return {
        "pushes": [(head, sorted(body)) for head, body in phases],
        "initial": (subscribed, unsubscribed),
        "ejected": ejected,
        "stalled": stalled,
        "again": again,
        "damped": (damped_first, damped_second),
        "evaluator": type(service.scheduling.evaluator).__name__,
    }, isinstance(getattr(service.scheduling.evaluator, "_scorer", None), FusedMLPScorer)


def _claim_anyone(self, peer_id):
    """Planted fault: claim a push slot for a child that never subscribed."""
    return True


@pytest.mark.parametrize("fault", [None, "push_unsubscribed"])
@pytest.mark.parametrize("algorithm", ["default", "ml"])
def test_pushes_equal_the_jax_packages(tmp_path, monkeypatch, algorithm, fault):
    want, _ = run_swarm("jax", algorithm, tmp_path, monkeypatch)
    if fault:
        monkeypatch.setattr(t_push.PeerStreamHub, "claim", _claim_anyone)
        monkeypatch.setattr(t_push.PeerStreamHub, "subscribed", _claim_anyone)
    before = t_metrics.SCHEDULE_TOTAL.value(outcome="push_parents")
    got, fused = run_swarm("port", algorithm, tmp_path, monkeypatch)
    assert fused is (algorithm == "ml")
    # The reference's own promises, in the JAX run.
    assert all(e["bad_node"] for e in want["ejected"])
    assert all(all(e["kept"].values()) for e in want["ejected"])
    ejections = [body for head, body in want["pushes"] if head[0] == "eject"]
    assert len(ejections) == TASKS and all(ejections)
    assert want["stalled"] > 0 and want["again"] == 0
    assert want["damped"][0] > 0 and want["damped"][1] == 0
    if fault is None:
        assert got == want
        pushed = sum(len(body) for _, body in got["pushes"])
        assert t_metrics.SCHEDULE_TOTAL.value(outcome="push_parents") == before + pushed
    else:
        assert got != want
        assert not all(all(e["kept"].values()) for e in got["ejected"])


def test_ejected_parent_is_never_pushed_and_its_edges_go(tmp_path, monkeypatch):
    """One push for each subscribed child of the bad parent, none of them
    naming it; only unsubscribed children stay on it; the stall sweep's
    pushes equal its count."""
    got, _ = run_swarm("port", "ml", tmp_path, monkeypatch)
    ejects = [(head, body) for head, body in got["pushes"] if head[0] == "eject"]
    assert len(ejects) == TASKS
    for (head, body), e in zip(ejects, got["ejected"]):
        _, bad_peer, bad_host = head
        assert bad_peer == e["bad"]
        pushed = [child for child, _ in body]
        subscribed_children = {c for c in e["children_of_bad"] if c not in e["kept"]}
        # One push at most a child, only to subscribed ones, never naming
        # the bad parent; a child the push moved left it, and only the
        # unsubscribed and the unmoved (no other candidate) stay on it.
        assert len(set(pushed)) == len(pushed) and set(pushed) <= subscribed_children
        assert len(pushed) >= len(subscribed_children) - 1
        assert all(parents and bad_host not in parents for _, parents in body)
        assert set(e["still_on_bad"]) == set(e["children_of_bad"]) - set(pushed)
    stall = dict(got["pushes"])[("stall",)]
    assert len(stall) == got["stalled"]
    assert len(dict(got["pushes"])[("cooldown",)]) == got["damped"][0]


def test_hub_register_claim_cooldown_and_stall_monitor():
    hub = t_push.PeerStreamHub(push_cooldown_s=0.2)
    got = []
    send = got.append
    hub.register("p", send)
    assert hub.subscribed("p") and not hub.subscribed("q")
    assert hub.claim("p") and not hub.claim("p") and not hub.claim("q")
    assert hub.push("p", "r1") and got == ["r1"]
    hub.unregister("p", lambda r: None)  # another stream's callback: kept
    assert hub.subscribed("p")

    def dead(result):
        raise ConnectionError("stream gone")

    hub.register("d", dead)
    assert not hub.push("d", "r2") and not hub.subscribed("d")
    hub.unregister("p", send)
    assert not hub.subscribed("p")

    class Sweeper:
        calls = []

        def reschedule_stalled(self, max_idle_s):
            self.calls.append(max_idle_s)
            return 0

    import time

    mon = t_push.StallMonitor(Sweeper(), max_idle_s=1.0, interval_s=0.05)
    mon.start()
    time.sleep(0.3)
    mon.stop()
    assert Sweeper.calls and set(Sweeper.calls) == {1.0}
