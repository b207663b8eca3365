"""Port parity: the learned-scheduling loop's control plane —
``dragonfly2_tpu_torch/{manager,rollout,lifecycle,scheduler/model_loader,
sim/lifecycle}`` against the same modules of ``dragonfly2_tpu``.

Every case runs the same inputs, made with numpy from a seed, through
both packages and compares what comes out: the arbiter's decisions, the
lifecycle store's rows, the replay evaluation's numbers, the rollout
controller's decision sequence and the registry states it leaves, the
registry's digest refusal, the daemon's epochs and lineage, the model
subscriber's installs, and the zero-human drill's verdicts.  The
cases are those of ``tests/test_lifecycle.py`` and
``tests/test_rollout.py``.  The port's trainers run with
``device="cpu"``.

Tolerances, stated: every comparison is exact (the control plane is
numpy and Python verbatim), except a shadow drain's candidate scores
(1e-5 relative: numpy may round a float32 product's last bit otherwise
when one drain scores many announces) and where trained weights enter — the
two packages initialize their trainers with other weights, so the
daemon and drill cases compare decisions, events and lineage, not
scores, and the drill's pump counts may differ.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

import dragonfly2_tpu.lifecycle as j_lifecycle
import dragonfly2_tpu.lifecycle.state as j_lstate
import dragonfly2_tpu.manager as j_manager
import dragonfly2_tpu.manager.registry as j_registry
import dragonfly2_tpu.manager.state as j_state
import dragonfly2_tpu.rollout as j_rollout
import dragonfly2_tpu.rollout.metrics as j_rmetrics
import dragonfly2_tpu.rollout.shadow as j_shadow
import dragonfly2_tpu.scheduler as j_sched
import dragonfly2_tpu.scheduler.metrics as j_smetrics
import dragonfly2_tpu.sim.lifecycle as j_sim
import dragonfly2_tpu.sim.swarm as j_swarm
import dragonfly2_tpu.trainer.export as j_export
import dragonfly2_tpu.trainer.streaming as j_stream
import dragonfly2_tpu_torch.lifecycle as t_lifecycle
import dragonfly2_tpu_torch.lifecycle.state as t_lstate
import dragonfly2_tpu_torch.manager as t_manager
import dragonfly2_tpu_torch.manager.registry as t_registry
import dragonfly2_tpu_torch.manager.state as t_state
import dragonfly2_tpu_torch.rollout as t_rollout
import dragonfly2_tpu_torch.rollout.metrics as t_rmetrics
import dragonfly2_tpu_torch.rollout.shadow as t_shadow
import dragonfly2_tpu_torch.scheduler as t_sched
import dragonfly2_tpu_torch.scheduler.metrics as t_smetrics
import dragonfly2_tpu_torch.sim.lifecycle as t_sim
import dragonfly2_tpu_torch.sim.swarm as t_swarm
import dragonfly2_tpu_torch.trainer.export as t_export
import dragonfly2_tpu_torch.trainer.streaming as t_stream
from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, DOWNLOAD_FEATURE_DIM

MODEL_NAME = "parent-bandwidth-mlp"
_COL = {name: i for i, name in enumerate(t_shadow.SHADOW_COLUMNS)}


def _pkg(lifecycle, lstate, manager, registry, state, rollout, rmetrics, shadow, sched,
         smetrics, sim, swarm, export, stream, trainer_kw):
    return types.SimpleNamespace(
        lifecycle=lifecycle, lstate=lstate, manager=manager, registry=registry, state=state,
        rollout=rollout, rmetrics=rmetrics, shadow=shadow, sched=sched, smetrics=smetrics,
        sim=sim, swarm=swarm, export=export, stream=stream, trainer_kw=trainer_kw,
    )


JAX = _pkg(j_lifecycle, j_lstate, j_manager, j_registry, j_state, j_rollout, j_rmetrics,
           j_shadow, j_sched, j_smetrics, j_sim, j_swarm, j_export, j_stream, {})
PORT = _pkg(t_lifecycle, t_lstate, t_manager, t_registry, t_state, t_rollout, t_rmetrics,
            t_shadow, t_sched, t_smetrics, t_sim, t_swarm, t_export, t_stream,
            {"device": "cpu"})


class _Close:
    """A float array compared at 1e-5 relative, not bit for bit: numpy's
    float32 matmul may round the last bit differently when the shadow
    worker scores one drain of many announces or several smaller ones."""

    def __init__(self, value):
        self.value = np.asarray(value)


def _same(a, b, path="out"):
    """Recursive equality: dicts, sequences, floats (NaN equal), arrays."""
    if isinstance(a, _Close):
        np.testing.assert_allclose(a.value, b.value, rtol=1e-5, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), (path, a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _both(fn):
    """Run ``fn(pkg)`` on both packages; the outputs must be equal."""
    got, want = fn(PORT), fn(JAX)
    _same(got, want)
    return got


def _mk_scorer(pkg, seed, invert=False):
    rng = np.random.default_rng(seed)
    dims = (DOWNLOAD_FEATURE_DIM, 16, 1)
    ws = [
        (
            rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
            rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05,
        )
        for i in range(len(dims) - 1)
    ]
    if invert:
        ws[-1] = (-ws[-1][0], -ws[-1][1])
    return pkg.export.MLPScorer(weights=ws)


def _blob(pkg, seed, invert=False):
    return pkg.export.scorer_to_bytes(_mk_scorer(pkg, seed, invert))


def _shadow_report(joined=500, regret=0.05):
    return {
        "joined_edges": joined,
        "announces": joined // 4,
        "regret_at_k": {"k": 4, "candidate": regret, "active": 0.3},
        "inversion_rate": {"pairs": joined, "candidate": 0.1, "active": 0.3},
        "psi_max": 0.01,
    }


def _report(joined=500, cand_regret=0.1, active_regret=0.1, cand_inv=0.2, active_inv=0.2,
            psi=0.01):
    return {
        "joined_edges": joined,
        "announces": joined // 4,
        "regret_at_k": {"k": 4, "candidate": cand_regret, "active": active_regret},
        "inversion_rate": {"pairs": joined, "candidate": cand_inv, "active": active_inv},
        "psi_max": psi,
    }


# ---------------------------------------------------------------------------
# The arbiter (tests/test_lifecycle.py:93-183)
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "holds_below_cadence": dict(records_seen=100, watermark=0, epoch_records=256,
                                candidate_in_flight=False),
    "cuts_at_cadence": dict(records_seen=300, watermark=0, epoch_records=256,
                            candidate_in_flight=False),
    "candidate_in_flight": dict(records_seen=10_000, watermark=0, epoch_records=256,
                                candidate_in_flight=True),
    "disabled_cadence": dict(records_seen=10_000, watermark=0, epoch_records=0,
                             candidate_in_flight=False),
    "watermark_ahead": dict(records_seen=10, watermark=500, epoch_records=16,
                            candidate_in_flight=False),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_epoch_equals_the_jax_package(case):
    out = _both(lambda p: p.lifecycle.plan_epoch(**PLAN_CASES[case]))
    assert out["train"] == (case == "cuts_at_cadence")


ARBITRATION_CASES = {
    "thin_evidence_holds": ({"global": _shadow_report(joined=10)}, dict(min_joined=50)),
    "regional_beats_by_margin": ({
        "global": _shadow_report(regret=0.30),
        "idc-a": _shadow_report(regret=0.21),
        "idc-b": _shadow_report(regret=0.29),
    }, dict(min_joined=50, margin=0.02)),
    "global_beaten_everywhere": ({
        "global": _shadow_report(regret=0.50),
        "idc-a": _shadow_report(regret=0.10),
        "idc-b": _shadow_report(regret=0.20),
    }, dict(min_joined=50, margin=0.02)),
    "regional_without_global": ({"idc-a": _shadow_report(regret=0.4)}, dict(min_joined=50)),
    "held_global_holds_regionals": ({
        "global": _shadow_report(joined=10),
        "idc-a": _shadow_report(regret=0.01),
    }, dict(min_joined=50, margin=0.02)),
    "mixed_defaults": ({
        "global": _shadow_report(regret=0.30),
        "idc-a": _shadow_report(regret=0.21),
        "idc-b": _shadow_report(regret=0.35),
        "idc-c": _shadow_report(joined=10),
    }, {}),
}


@pytest.mark.parametrize("order", ["forward", "reversed"])
@pytest.mark.parametrize("case", sorted(ARBITRATION_CASES))
def test_arbitrate_candidates_equals_the_jax_package(case, order):
    reports, kw = ARBITRATION_CASES[case]
    keys = list(reports) if order == "forward" else list(reversed(list(reports)))
    out = _both(lambda p: p.lifecycle.arbitrate_candidates({k: reports[k] for k in keys}, **kw))
    forward = t_lifecycle.arbitrate_candidates(dict(reports), **kw)
    assert json.dumps(out, sort_keys=True) == json.dumps(forward, sort_keys=True)


@pytest.mark.parametrize("region", [None, "global", "idc-a", ""])
def test_regional_model_name_equals_the_jax_package(region):
    _both(lambda p: p.lifecycle.regional_model_name(MODEL_NAME, region))


# ---------------------------------------------------------------------------
# LifecycleStore (tests/test_lifecycle.py:190-236)
# ---------------------------------------------------------------------------


def _store_defaults(p):
    return p.lifecycle.LifecycleStore(p.state.MemoryBackend()).row("global")


def _store_reload(p):
    backend = p.state.MemoryBackend()
    store = p.lifecycle.LifecycleStore(backend)
    store.update("global", epoch=3, watermark=4096, candidate_id="m-7", candidate_version=7)
    store.append_history("global", {"epoch": 3, "event": "registered"})
    resumed = p.lifecycle.LifecycleStore(backend)
    return [resumed.row("global"), resumed.candidate("global"), resumed.keys()]


def _store_history_bounded(p):
    store = p.lifecycle.LifecycleStore(p.state.MemoryBackend())
    for i in range(p.lstate.HISTORY_KEEP + 20):
        store.append_history("global", {"epoch": i, "event": "registered"})
    return store.row("global")["history"]


def _store_cleared_candidate(p):
    store = p.lifecycle.LifecycleStore(None)
    store.update("global", candidate_id="m-1")
    store.update("global", candidate_id="")
    return [store.candidate("global"), store.row("global")]


STORE_CASES = {f.__name__[7:]: f for f in (
    _store_defaults, _store_reload, _store_history_bounded, _store_cleared_candidate)}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_lifecycle_store_equals_the_jax_package(case):
    _both(STORE_CASES[case])


# ---------------------------------------------------------------------------
# Replay evaluation (tests/test_rollout.py:316-392)
# ---------------------------------------------------------------------------


def _shadow_rows(per_announce, announces, cand_rank_fn, active_rank_fn, version=2):
    rows = []
    for a in range(announces):
        n = per_announce
        r = np.zeros((n, len(t_shadow.SHADOW_COLUMNS)), np.float32)
        r[:, _COL["announce_seq"]] = a
        r[:, _COL["candidate_version"]] = version
        r[:, _COL["src_bucket"]] = np.arange(n) + a * n
        r[:, _COL["dst_bucket"]] = 99_000 + a
        r[:, _COL["active_rank"]] = active_rank_fn(n)
        r[:, _COL["candidate_rank"]] = cand_rank_fn(n)
        rows.append(r)
    return np.concatenate(rows, axis=0)


def _eval_join(p):
    sh = np.zeros((3, len(t_shadow.SHADOW_COLUMNS)), np.float32)
    sh[:, _COL["src_bucket"]] = [1, 2, 3]
    sh[:, _COL["dst_bucket"]] = [9, 9, 9]
    dl = np.zeros((3, len(DOWNLOAD_COLUMNS)), np.float32)
    dl[:, 0] = [1, 1, 2]
    dl[:, 1] = [9, 9, 9]
    dl[:, -1] = [10.0, 20.0, 7.0]
    return p.rollout.join_outcomes(sh, dl)


def _eval_regret_inverted(p):
    rows = _shadow_rows(8, 10, lambda n: np.arange(n)[::-1], lambda n: np.arange(n))
    realized = np.log1p(np.tile(np.linspace(100.0, 10.0, 8), 10))
    return p.rollout.regret_at_k(rows, realized, k=4)


def _eval_regret_tiny_groups(p):
    rows = _shadow_rows(2, 3, lambda n: np.arange(n), lambda n: np.arange(n))
    realized = np.full(rows.shape[0], np.nan)
    realized[0] = 5.0
    return p.rollout.regret_at_k(rows, realized, k=2)


def _eval_inversion_hand(p):
    rows = _shadow_rows(3, 1, lambda n: np.array([2, 1, 0]), lambda n: np.array([0, 1, 2]))
    return p.rollout.pairwise_inversion_rate(rows, np.log1p(np.array([30.0, 20.0, 10.0])))


def _eval_psi(p):
    expected = np.array([[0.25, 0.25, 0.25, 0.25]])
    return [p.rollout.population_stability_index(expected, np.array([[25, 25, 25, 25]])),
            p.rollout.population_stability_index(expected, np.array([[97, 1, 1, 1]]))]


def _eval_report_shape(p):
    rows = _shadow_rows(4, 5, lambda n: np.arange(n), lambda n: np.arange(n))
    dl = np.zeros((rows.shape[0], len(DOWNLOAD_COLUMNS)), np.float32)
    dl[:, 0] = rows[:, _COL["src_bucket"]]
    dl[:, 1] = rows[:, _COL["dst_bucket"]]
    dl[:, -1] = 5.0
    return p.rollout.evaluate_shadow(rows, dl, k=2, psi_max=0.03)


def _eval_seeded_log(p):
    """A seeded log with ties, unjoined edges and repeated pairs."""
    rng = np.random.default_rng(12)
    n = 600
    rows = np.zeros((n, len(t_shadow.SHADOW_COLUMNS)), np.float32)
    rows[:, _COL["announce_seq"]] = np.repeat(np.arange(100), 6)
    rows[:, _COL["candidate_version"]] = rng.integers(2, 4, n)
    rows[:, _COL["src_bucket"]] = rng.integers(0, 300, n)
    rows[:, _COL["dst_bucket"]] = rng.integers(0, 5, n)
    rows[:, _COL["active_rank"]] = np.tile(np.arange(6), 100)
    rows[:, _COL["candidate_rank"]] = rng.permuted(np.tile(np.arange(6), (100, 1)), axis=1).ravel()
    dl = np.zeros((400, len(DOWNLOAD_COLUMNS)), np.float32)
    dl[:, 0] = rng.integers(0, 300, 400)
    dl[:, 1] = rng.integers(0, 5, 400)
    dl[:, -1] = np.round(rng.random(400) * 4, 1) + 10
    return p.rollout.evaluate_shadow(rows, dl, k=3, psi_max=None)


EVAL_CASES = {f.__name__[6:]: f for f in (
    _eval_join, _eval_regret_inverted, _eval_regret_tiny_groups, _eval_inversion_hand,
    _eval_psi, _eval_report_shape, _eval_seeded_log)}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_replay_evaluation_equals_the_jax_package(case):
    _both(EVAL_CASES[case])


# ---------------------------------------------------------------------------
# Shadow scoring
# ---------------------------------------------------------------------------


class _ConstScorer:
    """Scores row i as base + step*i — rankings are predictable."""

    def __init__(self, base=0.0, step=1.0):
        self.base, self.step = base, step

    def score(self, features, **_buckets):
        return self.base + self.step * np.arange(features.shape[0], dtype=np.float64)


def _shadow_sampling(p):
    return [[p.shadow.sampled(f"child-{c}", seq, rate) for seq in range(300)]
            for c in range(3) for rate in (0.0, 0.1, 0.37, 1.0)]


def _shadow_digest(p):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((5, 32)).astype(np.float32)
    return [p.shadow.feature_digest(f, np.arange(5)),
            p.shadow.feature_digest(np.zeros((3, 0), np.float32), np.arange(3))]


def _shadow_replay_ranks(p):
    sh = p.rollout.ShadowScorer(_ConstScorer(), candidate_version=3, active_version=1,
                                sample_rate=1.0)
    sh.offer("c", np.zeros((3, 2), np.float32), np.array([11, 12, 13]), np.array([7, 7, 7]),
             np.array([5.0, 1.0, 3.0]))
    sh.drain()
    sh.close()
    return sh.replay_rows()


def _shadow_batched_drain(p):
    rng = np.random.default_rng(3)
    sh = p.rollout.ShadowScorer(_mk_scorer(p, 4), candidate_version=2, sample_rate=1.0,
                                batch_linger_s=0.25)
    for a in range(6):
        n = 4 + a
        feats = rng.standard_normal((n, DOWNLOAD_FEATURE_DIM)).astype(np.float32)
        sh.offer(f"c{a}", feats, np.arange(n, dtype=np.int64) + 100 * a,
                 np.full(n, a, np.int64), rng.standard_normal(n))
    sh.drain(timeout=10.0)
    rows = sh.replay_rows()
    sh.close()
    rows = rows[np.lexsort((rows[:, _COL["src_bucket"]], rows[:, _COL["dst_bucket"]]))]
    score = _COL["candidate_score"]
    return [np.delete(rows, score, axis=1), _Close(rows[:, score])]


def _shadow_psi(p):
    rng = np.random.default_rng(0)
    edges, fracs = p.export.feature_snapshot_stats(
        rng.standard_normal((4000, 5)).astype(np.float32))
    cand = _ConstScorer()
    cand.train_bin_edges, cand.train_bin_fracs, cand.post_hoc_masked = edges, fracs, False
    out = []
    for shift in (0.0, 2.0):
        sh = p.rollout.ShadowScorer(cand, candidate_version=2, sample_rate=1.0)
        rows = (rng.standard_normal((2000, 5)) + shift).astype(np.float32)
        sh.offer("c", rows, np.zeros(2000, np.int64), np.zeros(2000, np.int64), np.zeros(2000))
        sh.drain()
        out.append(sh.psi())
        stats = sh.stats()
        sh.close()
        out.append({k: stats[k] for k in ("offered", "scored_announces", "psi_max")})
    return out


SHADOW_CASES = {f.__name__[8:]: f for f in (
    _shadow_sampling, _shadow_digest, _shadow_replay_ranks, _shadow_batched_drain,
    _shadow_psi)}


@pytest.mark.parametrize("case", sorted(SHADOW_CASES))
def test_shadow_scorer_equals_the_jax_package(case):
    _both(SHADOW_CASES[case])


def test_shadow_drops_instead_of_blocking():
    import threading

    release = threading.Event()

    class Slow:
        def score(self, features, **_b):
            release.wait(5.0)
            return np.zeros(features.shape[0])

    sh = t_rollout.ShadowScorer(Slow(), candidate_version=2, sample_rate=1.0, max_queue=1)
    args = (np.zeros(2, np.int64), np.zeros(2, np.int64), np.zeros(2))
    for _ in range(6):
        sh.offer("c", np.zeros((2, 2), np.float32), *args)
    release.set()
    sh.drain()
    stats = sh.stats()
    sh.close()
    assert stats["dropped"] > 0 and stats["offered"] == 6
    assert stats["scored_announces"] + stats["dropped"] == 6


# ---------------------------------------------------------------------------
# RolloutController report sequences (tests/test_rollout.py:630-741)
# ---------------------------------------------------------------------------


def _v1_active_v2(p, reg=None, invert_v2=True, sched="s1", v2_seed=2):
    reg = reg or p.manager.ModelRegistry()
    m1 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id=sched,
                          artifact=_blob(p, 1))
    reg.activate(m1.id)
    m2 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id=sched,
                          artifact=_blob(p, v2_seed, invert=invert_v2))
    return reg, m1, m2


def _states(reg):
    return {m.id: m.state.value for m in reg.list()}


def _rollout_row(ctrl):
    r = ctrl.get("s1", MODEL_NAME)
    if r is None:
        return None
    return {k: getattr(r, k) for k in ("model_id", "version", "phase", "previous_active_id",
                                        "canary_percent", "reports", "joined_edges",
                                        "phase_baseline", "reason")}


def _run_sequence(p, guard, reports, *, restart_guard=None):
    """begin v2, then post ``reports``; a ``None`` report restarts the
    controller over the same backend with ``restart_guard``."""
    backend = p.state.MemoryBackend()
    reg, m1, m2 = _v1_active_v2(p)
    ctrl = p.rollout.RolloutController(reg, backend=backend,
                                       guardrails=p.rollout.RolloutGuardrails(**guard))
    out = [ctrl.to_json(ctrl.begin(m2.id))]
    out[0] = {k: v for k, v in out[0].items() if k not in ("started_at", "updated_at")}
    for rep in reports:
        if rep is None:
            ctrl = p.rollout.RolloutController(
                reg, backend=backend, guardrails=p.rollout.RolloutGuardrails(**restart_guard))
            out.append(_rollout_row(ctrl))
            continue
        out.append(ctrl.report("s1", MODEL_NAME, rep))
        out.append(_states(reg))
        out.append(p.rmetrics.ROLLOUT_STATE.value(scheduler_id="s1", name=MODEL_NAME))
    out.append(_rollout_row(ctrl))
    active = reg.active_model("s1", MODEL_NAME)
    out.append(active.id if active else None)
    return out


CONTROLLER_CASES = {
    "hold_below_sample_floor": (dict(min_shadow_samples=100), [_report(joined=10)], None),
    "walk_shadow_canary_active": (
        dict(min_shadow_samples=50, min_canary_samples=50, canary_percent=25),
        [_report(joined=60), _report(joined=80), _report(joined=130)], None),
    "regret_breach_rolls_back": (
        dict(min_shadow_samples=50),
        [_report(joined=100, cand_regret=0.5, active_regret=0.1), _report(joined=200)], None),
    "psi_breach_rolls_back": (dict(min_shadow_samples=10, max_psi=0.25),
                              [_report(joined=50, psi=0.9)], None),
    "inversion_breach_rolls_back": (
        dict(min_shadow_samples=10), [_report(joined=50, cand_inv=0.6, active_inv=0.2)], None),
    "post_promotion_regression_reactivates_last_good": (
        dict(min_shadow_samples=10, min_canary_samples=10),
        [_report(joined=20), _report(joined=40),
         _report(joined=60, cand_regret=0.9, active_regret=0.1)], None),
    "persists_across_controller_restart": (
        dict(min_shadow_samples=10), [_report(joined=20), None, _report(joined=40)],
        dict(min_canary_samples=10)),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_rollout_controller_sequence_equals_the_jax_package(case):
    guard, reports, restart = CONTROLLER_CASES[case]
    out = _both(lambda p: _run_sequence(p, guard, reports, restart_guard=restart))
    decisions = [o["decision"] for o in out if isinstance(o, dict) and "decision" in o]
    assert decisions, out


def test_begin_refuses_an_active_model_in_both_packages():
    for p in (PORT, JAX):
        reg, m1, m2 = _v1_active_v2(p)
        ctrl = p.rollout.RolloutController(reg)
        ctrl.begin(m2.id)
        with pytest.raises(ValueError):
            ctrl.begin(m1.id)


def _reconcile_orphan(p):
    """A SHADOW model with no rollout row is adopted on controller load;
    a row whose model is gone is dropped."""
    backend = p.state.MemoryBackend()
    reg, m1, m2 = _v1_active_v2(p)
    reg.set_state(m2.id, p.manager.ModelState.SHADOW)
    ctrl = p.rollout.RolloutController(reg, backend=backend)
    adopted = _rollout_row(ctrl)
    ctrl.delete_model(m2.id)
    return [adopted, _rollout_row(ctrl), _states(reg)]


def test_controller_reconcile_equals_the_jax_package():
    _both(_reconcile_orphan)


# ---------------------------------------------------------------------------
# Registry: digest refusal and durability (tests/test_rollout.py:500-605)
# ---------------------------------------------------------------------------


def _digest_recorded_and_verified(p, tmp):
    blobs = p.registry.BlobStore(str(tmp / "blobs"))
    reg = p.manager.ModelRegistry(blobs)
    m = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1", artifact=_blob(p, 1))
    ok = p.export.load_scorer(reg.load_artifact(m)) is not None
    blobs.put(m.blob_key, b"corrupted bytes")
    with pytest.raises(p.manager.ArtifactDigestError) as err:
        reg.load_artifact(m)
    return [m.id, m.blob_key, m.artifact_digest, ok, str(err.value)]


def _legacy_row_loads(p, tmp):
    blobs = p.registry.BlobStore()
    reg = p.manager.ModelRegistry(blobs)
    m = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1", artifact=b"x")
    m.artifact_digest = ""
    blobs.put(m.blob_key, b"whatever")
    return reg.load_artifact(m)


def _subscriber_refuses_corrupted_blob(p, tmp):
    backend = p.state.MemoryBackend()
    blobs = p.registry.KVBlobStore(backend)
    reg = p.manager.ModelRegistry(blobs, backend=backend)
    m1 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1", artifact=_blob(p, 1))
    reg.activate(m1.id)
    ml = p.sched.MLEvaluator(None)
    sub = p.sched.ModelSubscriber(reg, ml, scheduler_id="s1")
    first = sub.refresh()
    serving = ml._scorer
    m2 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1", artifact=_blob(p, 2))
    blobs.put(m2.blob_key, b"\x00" * 64)
    reg.activate(m2.id)
    second = sub.refresh()
    return [first, second, ml._scorer is serving, sub._loaded_version, _states(reg)]


def _candidate_states_exclusive(p, tmp):
    backend = p.state.MemoryBackend()
    reg = p.manager.ModelRegistry(backend=backend)
    m1 = reg.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"1")
    m2 = reg.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"2")
    reg.set_state(m1.id, p.manager.ModelState.SHADOW)
    reg.set_state(m2.id, p.manager.ModelState.CANARY)
    reg2 = p.manager.ModelRegistry(backend=backend)
    return [_states(reg2), reg2.candidate_model("s", "m").id]


def _delete_active_leaves_no_pointer(p, tmp):
    backend = p.state.MemoryBackend()
    reg = p.manager.ModelRegistry(backend=backend)
    m1 = reg.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"1")
    m2 = reg.create_model(name="m", type="mlp", scheduler_id="s", artifact=b"2")
    reg.activate(m2.id)
    reg.delete(m2.id)
    reg3 = p.manager.ModelRegistry(backend=backend)
    out = [reg3.active_model("s", "m"), [m.id for m in reg3.list(scheduler_id="s", name="m")]]
    reg3.activate(m1.id)
    return out + [reg3.active_model("s", "m").id]


def _unknown_type_refused(p, tmp):
    with pytest.raises(ValueError):
        p.manager.ModelRegistry().create_model(name="m", type="onnx", scheduler_id="s",
                                               artifact=b"")
    return True


REGISTRY_CASES = {f.__name__[1:]: f for f in (
    _digest_recorded_and_verified, _legacy_row_loads, _subscriber_refuses_corrupted_blob,
    _candidate_states_exclusive, _delete_active_leaves_no_pointer, _unknown_type_refused)}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_equals_the_jax_package(case, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = REGISTRY_CASES[case](PORT, tmp_path / "port")
    want = REGISTRY_CASES[case](JAX, tmp_path / "jax")
    _same(got, want)


# ---------------------------------------------------------------------------
# LifecycleDaemon units (tests/test_lifecycle.py:243-463)
# ---------------------------------------------------------------------------


def _drill_cfg(p, **kw):
    kw.setdefault("epoch_records", 128)
    kw.setdefault("batch_size", 32)
    kw.setdefault("announces", 24)
    kw.setdefault("parents", 4)
    kw.setdefault("min_shadow_samples", 40)
    kw.setdefault("min_canary_samples", 40)
    return p.sim.LifecycleDrillConfig(**kw)


def _small_trainer(p, **cfg):
    cfg = {**dict(batch_size=32, warmup_steps=4, learning_rate=3e-3, snapshot_rows=512,
                  seed=11), **cfg}
    return lambda _key: p.stream.StreamingTrainer(p.stream.StreamingConfig(**cfg),
                                                  **p.trainer_kw)


def _replay_source_for(p, registry, world, cfg, sid):
    acc = {}

    def source(key):
        name = p.lifecycle.regional_model_name(cfg.model_name, key)
        cand = registry.candidate_model(sid, name)
        if cand is None:
            return None
        active = registry.active_model(sid, name)
        shadow, dl, _ = world.shadow_batch(
            p.export.load_scorer(registry.load_artifact(cand)), cand.version,
            p.export.load_scorer(registry.load_artifact(active)) if active else None,
            active.version if active else 0,
        )
        slot = acc.get(key)
        if slot is None or slot["version"] != cand.version:
            slot = {"version": cand.version, "shadow": [], "dl": []}
            acc[key] = slot
        slot["shadow"].append(shadow)
        slot["dl"].append(dl)
        return (np.concatenate(slot["shadow"]), np.concatenate(slot["dl"]))

    return source


def _daemon(p, registry, controller, backend=None, **cfg):
    return p.lifecycle.LifecycleDaemon(
        registry, p.rollout.LocalRolloutClient(controller),
        config=p.lifecycle.LifecycleConfig(scheduler_id="s1", **cfg),
        backend=backend, trainer_factory=_small_trainer(p),
    )


def _row(daemon, key="global"):
    return daemon.store.row(key)


def _daemon_defers_until_full_batch(p):
    backend = p.state.MemoryBackend()
    registry = p.manager.ModelRegistry(backend=backend)
    daemon = _daemon(p, registry, p.rollout.RolloutController(registry, backend=backend),
                     backend, epoch_records=16)
    world = p.sim._World(_drill_cfg(p))
    daemon.feed(world.record_rows(20))
    out = [daemon.step(), _row(daemon)]
    daemon.feed(world.record_rows(44))
    out += [daemon.step()["epochs"], _row(daemon), _states(registry)]
    return out


def _daemon_storeless_watermark(p):
    registry = p.manager.ModelRegistry()
    daemon = _daemon(p, registry, p.rollout.RolloutController(registry), epoch_records=16)
    world = p.sim._World(_drill_cfg(p))
    daemon.feed(world.record_rows(64))
    out = [daemon.step()["epochs"], _row(daemon)]
    registry.deactivate(registry.candidate_model("s1", daemon.config.model_name).id)
    out += [daemon.step(), _row(daemon), _states(registry)]
    return out


def _daemon_starved_second_epoch(p):
    backend = p.state.MemoryBackend()
    registry = p.manager.ModelRegistry(backend=backend)
    daemon = _daemon(p, registry, p.rollout.RolloutController(registry, backend=backend),
                     backend, epoch_records=16)
    world = p.sim._World(_drill_cfg(p))
    daemon.feed(world.record_rows(64))
    out = [daemon.step()["epochs"]]
    registry.deactivate(registry.candidate_model("s1", daemon.config.model_name).id)
    daemon.feed(world.record_rows(20))
    out += [daemon.step(), _row(daemon)]
    daemon.feed(world.record_rows(44))
    out += [daemon.step()["epochs"], _row(daemon), daemon._trainers["global"].step]
    return out


def _daemon_full_queue(p):
    registry = p.manager.ModelRegistry()
    daemon = p.lifecycle.LifecycleDaemon(
        registry, p.rollout.LocalRolloutClient(p.rollout.RolloutController(registry)),
        config=p.lifecycle.LifecycleConfig(scheduler_id="s1", epoch_records=16),
        trainer_factory=_small_trainer(p, queue_capacity=1),
    )
    world = p.sim._World(_drill_cfg(p))
    daemon.feed(world.record_rows(8))
    daemon.feed(world.record_rows(8))
    return [daemon.records_seen("global"), daemon.records_dropped("global")]


def _daemon_orphan_reentered(p):
    registry = p.manager.ModelRegistry()
    m1 = registry.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1",
                               artifact=_blob(p, 1))
    registry.activate(m1.id)
    controller = p.rollout.RolloutController(registry)
    m2 = registry.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1",
                               artifact=_blob(p, 2))
    registry.set_state(m2.id, p.manager.ModelState.SHADOW)
    before = _rollout_row(controller)
    cfg = _drill_cfg(p)
    daemon = p.lifecycle.LifecycleDaemon(
        registry, p.rollout.LocalRolloutClient(controller),
        config=p.lifecycle.LifecycleConfig(scheduler_id="s1", min_joined=10),
        backend=p.state.MemoryBackend(), trainer_factory=_small_trainer(p),
        replay_source=_replay_source_for(p, registry, p.sim._World(cfg), cfg, "s1"),
    )
    outcomes = daemon.pump_rollouts()
    return [before, outcomes, _rollout_row(controller)]


def _daemon_retires_regional(p):
    cfg = _drill_cfg(p)
    world = p.sim._World(cfg)
    backend = p.state.MemoryBackend()
    registry = p.manager.ModelRegistry(backend=backend)
    controller = p.rollout.RolloutController(
        registry, backend=backend,
        guardrails=p.rollout.RolloutGuardrails(min_shadow_samples=40, min_canary_samples=40))
    daemon = p.lifecycle.LifecycleDaemon(
        registry, p.rollout.LocalRolloutClient(controller),
        config=p.lifecycle.LifecycleConfig(
            scheduler_id="s1", regions=("idc-a",), epoch_records=128, max_steps_per_epoch=20,
            min_joined=10, arbitration_margin=0.25),
        backend=backend, trainer_factory=_small_trainer(p),
        replay_source=_replay_source_for(p, registry, world, cfg, "s1"),
    )
    daemon.feed(world.record_rows(160), region="idc-a")
    for _ in range(6):
        daemon.step()
        if registry.active_model("s1", MODEL_NAME):
            break
    regional = f"{MODEL_NAME}@idc-a"
    return [registry.active_model("s1", MODEL_NAME) is not None,
            registry.active_model("s1", regional), registry.candidate_model("s1", regional),
            [h["event"] for h in _row(daemon, "idc-a")["history"]],
            daemon.store.candidate("idc-a")]


DAEMON_CASES = {f.__name__[8:]: f for f in (
    _daemon_defers_until_full_batch, _daemon_storeless_watermark,
    _daemon_starved_second_epoch, _daemon_full_queue, _daemon_orphan_reentered,
    _daemon_retires_regional)}


@pytest.mark.parametrize("case", sorted(DAEMON_CASES))
def test_lifecycle_daemon_equals_the_jax_package(case):
    _both(DAEMON_CASES[case])


def test_the_default_trainer_trains_on_the_daemon_device():
    registry = t_manager.ModelRegistry()
    daemon = t_lifecycle.LifecycleDaemon(
        registry, t_rollout.LocalRolloutClient(t_rollout.RolloutController(registry)),
        config=t_lifecycle.LifecycleConfig(trainer_batch_size=16, trainer_snapshot_rows=64),
        device="cpu",
    )
    trainer = daemon._trainers["global"]
    assert isinstance(trainer, t_stream.StreamingTrainer)
    assert trainer.device.type == "cpu" and trainer.config.batch_size == 16


# ---------------------------------------------------------------------------
# The zero-human drill (tests/test_lifecycle.py:470-495)
# ---------------------------------------------------------------------------


def _verdicts(out):
    s1, s2, s3 = out["stage1"], out["stage2"], out["stage3"]
    return {
        "ok": out["ok"], "events": out["events"], "config": out["config"],
        "stage1": {k: s1[k] for k in ("active_version", "epoch", "candidate_clear")},
        "stage2": {"rolled_back": s2["rolled_back"], "active_version": s2["active_version"],
                   "reason": s2["rollback_reason"].split(":")[0]},
        "stage3": {k: s3[k] for k in ("had_in_flight", "resumed_watermark", "resumed_epoch",
                                      "pre_bounce_epoch", "promoted_resumed_candidate",
                                      "active_count", "artifact_ok")},
    }


@pytest.mark.parametrize("size", ["drill_default", "small"])
def test_lifecycle_drill_verdicts_equal_the_jax_package(size):
    kw = {} if size == "drill_default" else dict(
        epoch_records=128, batch_size=32, announces=24, parents=4, min_shadow_samples=40,
        min_canary_samples=40)
    port = t_sim.run_lifecycle_drill(t_sim.LifecycleDrillConfig(**kw), device="cpu")
    ref = j_sim.run_lifecycle_drill(j_sim.LifecycleDrillConfig(**kw))
    assert port["ok"], port
    _same(_verdicts(port), _verdicts(ref))
    assert port["events"][:3] == ["registered", "advance", "promote"]
    assert "regression" in port["stage2"]["rollback_reason"]


def test_world_draws_equal_the_jax_package():
    def draws(p):
        world = p.sim._World(p.sim.LifecycleDrillConfig(seed=5, announces=6, parents=3))
        rows = world.record_rows(40)
        cand, act = _mk_scorer(p, 1), _mk_scorer(p, 2)
        return [world.truth_w, rows, *world.shadow_batch(cand, 2, act, 1),
                *world.shadow_batch(cand, 2, None, 0)]
    _both(draws)


# ---------------------------------------------------------------------------
# ModelSubscriber: regional keys (tests/test_lifecycle.py:503-590) and the
# rollout walk on a port scheduler (tests/test_rollout.py:743-767)
# ---------------------------------------------------------------------------


def _two_arms(p):
    reg = p.manager.ModelRegistry()
    mg = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1", artifact=_blob(p, 1))
    reg.activate(mg.id)
    ma = reg.create_model(name=f"{MODEL_NAME}@idc-a", type="mlp", scheduler_id="s1",
                          artifact=_blob(p, 2))
    reg.activate(ma.id)
    return reg, mg, ma


def _sub_state(sub):
    return [sub._loaded_key, sub._loaded_version, sub.candidate_name, sub.pinned]


def _regional_serves_specialization(p):
    reg, _, _ = _two_arms(p)
    sub = p.sched.ModelSubscriber(reg, p.sched.MLEvaluator(None), scheduler_id="s1",
                                  idc="idc-a")
    return [sub.refresh(), _sub_state(sub)]


def _regional_no_bleed(p):
    reg, _, _ = _two_arms(p)
    out = []
    for idc in ("idc-b", None):
        sub = p.sched.ModelSubscriber(reg, p.sched.MLEvaluator(None), scheduler_id="s1",
                                      idc=idc)
        out.append([sub.refresh(), _sub_state(sub)])
    return out


def _regional_versions_per_key(p):
    reg, _, _ = _two_arms(p)
    sub = p.sched.ModelSubscriber(reg, p.sched.MLEvaluator(None), scheduler_id="s1",
                                  idc="idc-a")
    sub.refresh()
    mg2 = reg.create_model(name=MODEL_NAME, type="mlp", scheduler_id="s1", artifact=_blob(p, 3))
    reg.activate(mg2.id)
    return [sub.refresh(), _sub_state(sub)]


def _regional_retired_falls_back(p):
    reg, _, ma = _two_arms(p)
    sub = p.sched.ModelSubscriber(reg, p.sched.MLEvaluator(None), scheduler_id="s1",
                                  idc="idc-a")
    sub.refresh()
    reg.deactivate(ma.id)
    return [sub.refresh(), _sub_state(sub)]


def _regional_candidate_scopes_shadow(p):
    reg, _, _ = _two_arms(p)
    controller = p.rollout.RolloutController(reg)
    client = p.rollout.LocalRolloutClient(controller)
    m3 = reg.create_model(name=f"{MODEL_NAME}@idc-a", type="mlp", scheduler_id="s1",
                          artifact=_blob(p, 4))
    controller.begin(m3.id)
    out = []
    for idc in ("idc-a", "idc-b"):
        ml = p.sched.MLEvaluator(None)
        sub = p.sched.ModelSubscriber(reg, ml, scheduler_id="s1", idc=idc,
                                      rollout_client=client)
        sub.refresh()
        out.append([ml.shadow is not None, _sub_state(sub)])
        sub.stop()
    return out


def _pinned_on_manager_loss(p):
    reg, m1, m2 = _v1_active_v2(p, invert_v2=False)
    ctrl = p.rollout.RolloutController(reg, guardrails=p.rollout.RolloutGuardrails(
        min_shadow_samples=1, canary_percent=20))
    ctrl.begin(m2.id)
    ctrl.report("s1", MODEL_NAME, _report(joined=5))
    ml = p.sched.MLEvaluator(None)
    sub = p.sched.ModelSubscriber(reg, ml, scheduler_id="s1",
                                  rollout_client=p.rollout.LocalRolloutClient(ctrl))
    sub.refresh()
    before = [ml.canary.percent, ml.shadow is not None, _sub_state(sub)]
    serving = ml._scorer

    def down(*_a, **_k):
        raise ConnectionError("manager down")

    reg.active_model = down
    after = [sub.refresh(), ml.canary, ml.shadow, ml._scorer is serving, _sub_state(sub),
             p.smetrics.ROLLOUT_SERVING_STATE.value(name=MODEL_NAME)]
    sub.stop()
    return [before, after]


SUBSCRIBER_CASES = {f.__name__[1:]: f for f in (
    _regional_serves_specialization, _regional_no_bleed, _regional_versions_per_key,
    _regional_retired_falls_back, _regional_candidate_scopes_shadow, _pinned_on_manager_loss)}


@pytest.mark.parametrize("case", sorted(SUBSCRIBER_CASES))
def test_model_subscriber_equals_the_jax_package(case):
    _both(SUBSCRIBER_CASES[case])


def _port_scheduler():
    cfg = SchedulerConfig()
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.eval_batch_linger_ms = 0.0
    return build(cfg, device="cpu").scheduling.evaluator


def _jax_stack():
    return j_sched.MLEvaluator(None, feature_cache=j_sched.HostFeatureCache(max_hosts=1024),
                               batcher=j_sched.ScorerBatcher(linger_s=0.0))


def _walk(p, ml, drive):
    """tests/test_rollout.py:743: v1 active; v2 walks shadow → canary →
    active while the subscriber polls; ``drive`` serves announces between
    polls."""
    reg, m1, m2 = _v1_active_v2(p, invert_v2=False)
    ctrl = p.rollout.RolloutController(reg, guardrails=p.rollout.RolloutGuardrails(
        min_shadow_samples=1, min_canary_samples=1, canary_percent=30))
    sub = p.sched.ModelSubscriber(reg, ml, scheduler_id="s1",
                                  rollout_client=p.rollout.LocalRolloutClient(ctrl),
                                  shadow_sample_rate=1.0)
    gauge = lambda: p.smetrics.ROLLOUT_SERVING_STATE.value(name=MODEL_NAME)  # noqa: E731
    seen = []

    def look():
        drive(ml)
        seen.append([ml.shadow is not None, ml.canary.percent if ml.canary else None,
                     gauge(), _sub_state(sub)])

    sub.refresh()
    look()
    ctrl.begin(m2.id)
    sub.refresh()
    shadow = ml.shadow
    look()
    ctrl.report("s1", MODEL_NAME, _report(joined=5))
    sub.refresh()
    look()
    ctrl.report("s1", MODEL_NAME, _report(joined=10))
    sub.refresh()
    look()
    shadow.drain()
    seen.append(shadow.stats()["scored_announces"] > 0)
    seen.append(_states(reg))
    sub.stop()
    return seen, shadow, reg, m2


def _announcer(p, child_peers=40, count=12):
    task, peers = p.swarm.build_announce_swarm(child_peers, seed=7)

    def drive(ml):
        for i in range(count):
            child = peers[i % len(peers)]
            cands = [peers[(i + j + 1) % len(peers)] for j in range(6)]
            ml.evaluate_parents(cands, child, task.total_piece_count)

    return drive


def test_subscriber_walks_shadow_canary_active_on_a_port_scheduler():
    port_seen, shadow, reg, m2 = _walk(PORT, _port_scheduler(), _announcer(PORT))
    jax_seen, _, _, _ = _walk(JAX, _jax_stack(), _announcer(JAX))
    _same(port_seen, jax_seen)
    assert [s[:3] for s in port_seen[:4]] == [
        [False, None, 0.0], [True, None, 2.0], [True, 30, 3.0], [False, None, 0.0]]
    assert port_seen[3][3][1] == m2.version and port_seen[4] is True
    # The shadow engine logged v2 against v1 on the announces served.
    rows = shadow.replay_rows()
    assert rows.shape[0] > 0 and set(rows[:, _COL["candidate_version"]]) == {m2.version}
    assert set(rows[:, _COL["active_version"]]) == {1.0}
