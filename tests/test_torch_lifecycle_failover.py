"""Port parity: the lifecycle HA chaos drill (the reference's
``tests/test_lifecycle_failover.py``), run on both packages (``pkg``).

The leader manager dies mid-promotion with the worst tear the promotion
path can take: the registry's CANARY flip committed (and replicated), the
rollout-row persist dropped by an injected fault.  The standby, tailing
the leader over REST with a ``LogFollower`` on a shared fake clock,
promotes on the lease's expiry; a fresh plane over the replicated state
repairs the rollout row to the registry's phase, hands the resumed daemon
its watermark and in-flight candidate (no retrain), and walks to exactly
one ACTIVE per (region, name) with the artifact still digest-verified.
The second drill holds that the lifecycle store's rows ride the op log
and reload on a standby.  The port's trainers train on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_replication import Pkg, _Clock, _leader, _rest_for, _standby

MODEL_NAME = "parent-bandwidth-mlp"
SID = "scheduler-ha"
REGION = "idc-a"


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    p = Pkg(request.param)
    saved = p.utils__faultinject.active()
    yield p
    if saved is None:
        p.utils__faultinject.uninstall()
    else:
        p.utils__faultinject.install(saved)


def _drill_world(p):
    return p.sim__lifecycle._World(p.sim__lifecycle.LifecycleDrillConfig(
        seed=11, scheduler_id=SID, epoch_records=128, batch_size=32, announces=24, parents=4))


def _trainer(p):
    kw = {"device": "cpu"} if p.name == "torch" else {}
    stream = p.trainer__streaming

    def make(_key):
        return stream.StreamingTrainer(stream.StreamingConfig(
            batch_size=32, warmup_steps=4, learning_rate=3e-3, snapshot_rows=512, seed=11),
            **kw)
    return make


def _replay_source(p, registry, world):
    lc, load_scorer = p.lifecycle, p.trainer__export.load_scorer
    acc = {}

    def source(key):
        name = lc.regional_model_name(MODEL_NAME, key)
        cand = registry.candidate_model(SID, name)
        if cand is None:
            return None
        active = registry.active_model(SID, name)
        shadow, dl, _ = world.shadow_batch(
            load_scorer(registry.load_artifact(cand)), cand.version,
            load_scorer(registry.load_artifact(active)) if active else None,
            active.version if active else 0)
        slot = acc.get(key)
        if slot is None or slot["version"] != cand.version:
            slot = {"version": cand.version, "shadow": [], "dl": []}
            acc[key] = slot
        slot["shadow"].append(shadow)
        slot["dl"].append(dl)
        return (np.concatenate(slot["shadow"]), np.concatenate(slot["dl"]))

    return source


def _plane(p, backend, world):
    reg, ro, lc = p.manager__registry, p.rollout, p.lifecycle
    registry = reg.ModelRegistry(reg.KVBlobStore(backend), backend=backend)
    controller = ro.RolloutController(
        registry, backend=backend,
        guardrails=ro.RolloutGuardrails(min_shadow_samples=150, min_canary_samples=150,
                                        canary_percent=25))
    daemon = lc.LifecycleDaemon(
        registry, ro.LocalRolloutClient(controller),
        config=lc.LifecycleConfig(
            scheduler_id=SID, regions=(REGION,), epoch_records=128, max_steps_per_epoch=20,
            min_joined=10, arbitration_margin=0.25, canary_percent=25),
        backend=backend, trainer_factory=_trainer(p),
        replay_source=_replay_source(p, registry, world))
    return registry, controller, daemon


def test_promoted_standby_resumes_to_exactly_one_active(pkg):
    lc, fi = pkg.lifecycle, pkg.utils__faultinject
    ModelState = pkg.manager__registry.ModelState
    clock = _Clock()
    leader = _leader(pkg, clock)
    world = _drill_world(pkg)
    registry, controller, daemon = _plane(pkg, leader, world)
    rest = _rest_for(pkg, leader, registry)
    follower_backend = _standby(pkg, clock)
    follower = pkg.manager__replication.LogFollower(follower_backend, rest.url, clock=clock,
                                                    poll_interval_s=0.05)
    regional_name = lc.regional_model_name(MODEL_NAME, REGION)
    try:
        daemon.feed(world.record_rows(160), region=REGION)
        daemon.step()
        cand = registry.candidate_model(SID, MODEL_NAME)
        assert cand is not None and cand.state is ModelState.SHADOW
        assert registry.candidate_model(SID, regional_name) is None
        assert daemon.store.candidate(lc.GLOBAL_KEY) == cand.id
        inj = fi.FaultInjector([fi.FaultSpec(site="state.put.rollouts", kind="drop", at=(0,))])
        with fi.installed(inj):
            daemon.step()
        assert registry.get(cand.id).state is ModelState.CANARY
        torn = leader.table("rollouts").load_all()[f"{SID}:{MODEL_NAME}"]
        assert torn["phase"] == "shadow", "the drill needs the tear: registry CANARY, row SHADOW"
        assert registry.candidate_model(SID, regional_name) is None
        follower.poll_once()
    finally:
        rest.stop()
    clock.t = 30.0
    follower.poll_once()
    assert follower.promoted and follower_backend.role == "leader"

    registry2, controller2, daemon2 = _plane(pkg, follower_backend, world)
    repaired = controller2.get(SID, MODEL_NAME)
    assert repaired is not None and repaired.phase == "canary"
    assert "reconciled" in repaired.reason
    assert daemon2.store.candidate(lc.GLOBAL_KEY) == cand.id
    assert daemon2.store.row(lc.GLOBAL_KEY)["watermark"] == 160
    pre_models = len(registry2.list(scheduler_id=SID))
    for _ in range(8):
        daemon2.step()
        if registry2.active_model(SID, MODEL_NAME) is not None:
            break
    actives = registry2.list(scheduler_id=SID, name=MODEL_NAME, state=ModelState.ACTIVE)
    assert [m.id for m in actives] == [cand.id]
    assert registry2.list(scheduler_id=SID, name=regional_name, state=ModelState.ACTIVE) == []
    assert registry2.candidate_model(SID, regional_name) is None
    assert pkg.trainer__export.load_scorer(registry2.load_artifact(actives[0])) is not None
    assert daemon2.store.row(lc.GLOBAL_KEY)["epoch"] == 1
    assert len(registry2.list(scheduler_id=SID)) == pre_models
    assert daemon2.store.candidate(lc.GLOBAL_KEY) is None
    events = [h["event"] for h in daemon2.store.row(lc.GLOBAL_KEY)["history"]]
    assert events[0] == "registered" and events[-1] == "promote"


def test_store_rows_replicate_and_reload_on_the_standby(pkg):
    lc = pkg.lifecycle
    clock = _Clock()
    leader = _leader(pkg, clock)
    store = lc.LifecycleStore(leader)
    store.update(lc.GLOBAL_KEY, epoch=2, watermark=2048, candidate_id="m-9",
                 candidate_version=9)
    store.append_history(lc.GLOBAL_KEY, {"epoch": 2, "event": "registered"})
    follower = _standby(pkg, clock)
    follower.apply_ops(leader.log.entries_since(0))
    resumed = lc.LifecycleStore(follower)
    row = resumed.row(lc.GLOBAL_KEY)
    assert row["epoch"] == 2 and row["watermark"] == 2048
    assert resumed.candidate(lc.GLOBAL_KEY) == "m-9"
    assert row["history"] == [{"epoch": 2, "event": "registered"}]
    assert follower.log.entries_since(0) == leader.log.entries_since(0)
