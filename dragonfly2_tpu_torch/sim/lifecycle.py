"""Zero-human lifecycle drill (DESIGN.md §29).

The acceptance question for the self-driving lifecycle plane: does the
train→export→register→rollout loop reach ACTIVE **with zero human
steps**, does an injected regression auto-roll back to the last good
ACTIVE, and does a manager bounce mid-promotion RESUME the loop instead
of restarting it?  This module builds the smallest REAL composition that
can answer all three on one box:

- one ``ModelRegistry`` + ``RolloutController`` + ``LocalRolloutClient``
  over a shared ``MemoryBackend`` (the manager side, minus sockets);
- one ``LifecycleDaemon`` with real ``StreamingTrainer`` arms;
- a synthetic linear ground truth ``target = 3 + masked_feats · w``:
  fed records train the MLP against it, and the drill's replay source
  scores REAL exported scorer blobs (loaded back through the registry's
  digest-checked artifact path) against fresh draws from the same
  truth — so promotion and rollback verdicts come from the honest
  regret@k/inversion math in rollout/evaluation.py, never from scripted
  reports.

Stages (``run_lifecycle_drill``):

1. **unattended promotion** — feed one epoch of records, then only call
   ``daemon.step()``: epoch cut → scorer exported (drift baseline
   stamped) → CANDIDATE registered → SHADOW → CANARY → ACTIVE.
2. **injected regression** — the ``export_transform`` chaos hook negates
   the next export's output head; evaluation sees the anti-correlated
   ranking and the controller rolls the candidate back, keeping stage
   1's model ACTIVE (last-good).
3. **bounce resume** — a fresh registry/controller/daemon composition
   over the SAME backend mid-promotion: the lifecycle store hands back
   the watermark and in-flight candidate, the controller reconciles its
   rollout row, and the resumed daemon walks the candidate to ACTIVE —
   exactly one ACTIVE row, artifact digest intact.

``seed`` is the drill's single entropy source: the world's draws come
from it and the trainers are seeded with it.

Port of ``dragonfly2_tpu/sim/lifecycle.py``: the trainer arms are the
port's ``StreamingTrainer`` on ``device`` (``"cuda"`` unless the caller
asks for the CPU).  A seed initializes the port's trainers with other
weights than flax's, so verdicts and events match the reference's while
pump counts may differ.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..lifecycle import LifecycleConfig, LifecycleDaemon, regional_model_name
from ..manager.registry import KVBlobStore, ModelRegistry
from ..manager.state import MemoryBackend
from ..records.features import (
    DOWNLOAD_COLUMNS,
    DOWNLOAD_FEATURE_DIM,
    mask_post_hoc,
)
from ..rollout import LocalRolloutClient, RolloutController, RolloutGuardrails
from ..rollout.shadow import SHADOW_COLUMNS
from ..trainer.export import load_scorer

_COL = {name: i for i, name in enumerate(SHADOW_COLUMNS)}


@dataclass
class LifecycleDrillConfig:
    seed: int = 11
    model_name: str = "parent-bandwidth-mlp"
    scheduler_id: str = "scheduler-sim"
    epoch_records: int = 512
    batch_size: int = 64
    max_steps_per_epoch: int = 40
    announces: int = 80           # shadow announce groups per pump
    parents: int = 6              # candidate edges per announce
    min_shadow_samples: int = 200
    min_canary_samples: int = 200
    canary_percent: int = 25
    max_pumps: int = 12           # step() budget per stage


class _World:
    """The synthetic data plane: one linear ground truth shared by the
    training records and the replay evaluations."""

    def __init__(self, cfg: LifecycleDrillConfig) -> None:
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        w = self.rng.standard_normal(DOWNLOAD_FEATURE_DIM) * 0.5
        # Ground truth lives on the serving-visible features only:
        # mask_post_hoc zeroes outcome columns at train AND serve time,
        # so truth on masked columns would be unlearnable by design.
        self.truth_w = mask_post_hoc(w[None, :].astype(np.float32))[0]
        self._pair = 0

    def record_rows(self, n: int) -> np.ndarray:
        """n download records in DOWNLOAD_COLUMNS layout drawn from the
        ground truth (the daemon's training feed)."""
        feats = self.rng.standard_normal(
            (n, DOWNLOAD_FEATURE_DIM)
        ).astype(np.float32)
        rows = np.zeros((n, len(DOWNLOAD_COLUMNS)), np.float32)
        rows[:, 2:2 + DOWNLOAD_FEATURE_DIM] = feats
        rows[:, -1] = 3.0 + mask_post_hoc(feats) @ self.truth_w
        return rows

    def shadow_batch(
        self, cand_scorer, cand_version: int, active_scorer, active_version: int,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """One pump's worth of announce groups: fresh feature draws,
        both arms scored with the REAL blobs, per-announce ranks, and
        the realized download rows that the evaluation joins back on
        unique (src, dst) bucket pairs."""
        cfg = self.cfg
        n = cfg.announces * cfg.parents
        feats = self.rng.standard_normal(
            (n, DOWNLOAD_FEATURE_DIM)
        ).astype(np.float32)
        masked = mask_post_hoc(feats)
        target = 3.0 + masked @ self.truth_w
        cand_scores = np.asarray(cand_scorer.score(masked), np.float64)
        if active_scorer is not None:
            act_scores = np.asarray(active_scorer.score(masked), np.float64)
        else:
            # No ACTIVE yet (first rollout): the incumbent arm is the
            # heuristic scheduler — rank-agnostic for this drill.
            act_scores = self.rng.standard_normal(n)
        shadow = np.zeros((n, len(SHADOW_COLUMNS)), np.float32)
        seq0 = self._pair  # announce seq survives across pumps
        shadow[:, _COL["announce_seq"]] = seq0 + np.repeat(
            np.arange(cfg.announces), cfg.parents
        )
        self._pair = seq0 + cfg.announces
        shadow[:, _COL["candidate_version"]] = cand_version
        shadow[:, _COL["active_version"]] = active_version
        # Unique bucket pair per edge → the outcome join is exact.
        idx = np.arange(n) + seq0 * cfg.parents
        shadow[:, _COL["src_bucket"]] = idx % 997
        shadow[:, _COL["dst_bucket"]] = idx // 997 + 1
        for arm, scores in (("candidate", cand_scores), ("active", act_scores)):
            grouped = scores.reshape(cfg.announces, cfg.parents)
            order = np.argsort(-grouped, axis=1)
            ranks = np.argsort(order, axis=1)
            shadow[:, _COL[f"{arm}_score"]] = scores
            shadow[:, _COL[f"{arm}_rank"]] = ranks.reshape(-1)
        dl = np.zeros((n, len(DOWNLOAD_COLUMNS)), np.float32)
        dl[:, 0] = shadow[:, _COL["src_bucket"]]
        dl[:, 1] = shadow[:, _COL["dst_bucket"]]
        dl[:, -1] = target
        return shadow, dl, n


def _build_plane(cfg: LifecycleDrillConfig, backend, world, invert_flag, device="cuda"):
    """One manager+daemon composition over ``backend`` (stage 3 builds a
    second one over the same backend to model the bounce); the trainer
    arms train on ``device``."""
    registry = ModelRegistry(KVBlobStore(backend), backend=backend)
    controller = RolloutController(
        registry,
        backend=backend,
        guardrails=RolloutGuardrails(
            min_shadow_samples=cfg.min_shadow_samples,
            min_canary_samples=cfg.min_canary_samples,
            canary_percent=cfg.canary_percent,
        ),
    )
    client = LocalRolloutClient(controller)

    # Per-candidate-version shadow accumulator: the controller demands
    # NEW samples past each phase baseline, so each pump extends the
    # current candidate's log (and a version flip starts a fresh log,
    # like ShadowScorer's install reset).
    acc: Dict[str, dict] = {}

    def replay_source(key: str):
        name = regional_model_name(cfg.model_name, key)
        cand = registry.candidate_model(cfg.scheduler_id, name)
        if cand is None:
            return None
        active = registry.active_model(cfg.scheduler_id, name)
        cand_scorer = load_scorer(registry.load_artifact(cand))
        active_scorer = (
            load_scorer(registry.load_artifact(active)) if active else None
        )
        shadow, dl, _ = world.shadow_batch(
            cand_scorer, cand.version, active_scorer,
            active.version if active else 0,
        )
        slot = acc.get(key)
        if slot is None or slot["version"] != cand.version:
            slot = {"version": cand.version, "shadow": [], "dl": []}
            acc[key] = slot
        slot["shadow"].append(shadow)
        slot["dl"].append(dl)
        return (
            np.concatenate(slot["shadow"], axis=0),
            np.concatenate(slot["dl"], axis=0),
        )

    def export_transform(scorer, key, epoch):
        if invert_flag["invert"]:
            w, b = scorer.weights[-1]
            scorer.weights[-1] = (-w, -b)
        return scorer

    def trainer_factory(key: str):
        from ..trainer.streaming import StreamingConfig, StreamingTrainer

        return StreamingTrainer(
            StreamingConfig(
                batch_size=cfg.batch_size,
                warmup_steps=4,
                learning_rate=3e-3,
                snapshot_rows=512,
                seed=cfg.seed,
            ),
            device=device,
        )

    daemon = LifecycleDaemon(
        registry,
        client,
        config=LifecycleConfig(
            scheduler_id=cfg.scheduler_id,
            model_name=cfg.model_name,
            epoch_records=cfg.epoch_records,
            max_steps_per_epoch=cfg.max_steps_per_epoch,
            min_joined=cfg.min_shadow_samples // 4,
            canary_percent=cfg.canary_percent,
        ),
        backend=backend,
        trainer_factory=trainer_factory,
        replay_source=replay_source,
        export_transform=export_transform,
        device=device,
    )
    return registry, controller, daemon


def _pump_until(daemon, registry, cfg, done) -> int:
    """step() until ``done(registry)`` or the pump budget runs out;
    returns the number of steps taken."""
    for i in range(cfg.max_pumps):
        daemon.step()
        if done():
            return i + 1
    return cfg.max_pumps


def run_lifecycle_drill(
    cfg: Optional[LifecycleDrillConfig] = None, *, device="cuda"
) -> Dict[str, object]:
    cfg = cfg or LifecycleDrillConfig()
    world = _World(cfg)
    backend = MemoryBackend()
    invert = {"invert": False}
    registry, controller, daemon = _build_plane(cfg, backend, world, invert, device)
    name = cfg.model_name
    sid = cfg.scheduler_id

    def active_version() -> int:
        m = registry.active_model(sid, name)
        return m.version if m else 0

    # -- stage 1: unattended train → export → register → ACTIVE --------------
    t0 = time.perf_counter()
    daemon.feed(world.record_rows(cfg.epoch_records + cfg.batch_size))
    pumps1 = _pump_until(daemon, registry, cfg, lambda: active_version() == 1)
    stage1 = {
        "active_version": active_version(),
        "pumps": pumps1,
        "epoch": int(daemon.store.row("global")["epoch"]),
        "candidate_clear": daemon.store.candidate("global") is None,
        "wall_s": round(time.perf_counter() - t0, 4),
    }

    # -- stage 2: injected regression auto-rolls back ------------------------
    invert["invert"] = True
    t0 = time.perf_counter()
    daemon.feed(world.record_rows(cfg.epoch_records + cfg.batch_size))

    def rolled_back() -> bool:
        r = controller.get(sid, name)
        return r is not None and r.phase == "rolled_back"

    pumps2 = _pump_until(daemon, registry, cfg, rolled_back)
    invert["invert"] = False
    row2 = controller.get(sid, name)
    stage2 = {
        "rolled_back": rolled_back(),
        "rollback_reason": row2.reason if row2 else "",
        "active_version": active_version(),  # stage 1's model stays ACTIVE
        "pumps": pumps2,
        "wall_s": round(time.perf_counter() - t0, 4),
    }

    # -- stage 3: bounce mid-promotion, resumed plane finishes the walk ------
    t0 = time.perf_counter()
    daemon.feed(world.record_rows(cfg.epoch_records + cfg.batch_size))
    daemon.step()  # cut the epoch: candidate v3 registered, SHADOW begun
    in_flight = daemon.store.candidate("global")
    pre_bounce_epoch = int(daemon.store.row("global")["epoch"])
    # The bounce: every in-memory object is dropped; only the backend
    # (the replicated state in a real deployment) survives.
    registry2, controller2, daemon2 = _build_plane(cfg, backend, world, invert, device)

    def active_is_resumed_candidate() -> bool:
        m = registry2.active_model(sid, name)
        return m is not None and in_flight is not None and m.id == in_flight

    pumps3 = _pump_until(
        daemon2, registry2, cfg, active_is_resumed_candidate
    )
    from ..manager import ModelState

    actives = registry2.list(
        scheduler_id=sid, name=name, state=ModelState.ACTIVE
    )
    stage3 = {
        "had_in_flight": in_flight is not None,
        "resumed_watermark": int(daemon2.store.row("global")["watermark"]),
        "resumed_epoch": int(daemon2.store.row("global")["epoch"]),
        "pre_bounce_epoch": pre_bounce_epoch,
        "promoted_resumed_candidate": active_is_resumed_candidate(),
        "active_count": len(actives),
        "artifact_ok": bool(
            actives and registry2.load_artifact(actives[0]) is not None
        ),
        "pumps": pumps3,
        "wall_s": round(time.perf_counter() - t0, 4),
    }

    history: List[dict] = list(daemon2.store.row("global")["history"])
    return {
        "config": {
            "seed": cfg.seed,
            "epoch_records": cfg.epoch_records,
            "announces": cfg.announces,
            "parents": cfg.parents,
        },
        "stage1": stage1,
        "stage2": stage2,
        "stage3": stage3,
        "events": [h["event"] for h in history],
        "ok": bool(
            stage1["active_version"] == 1
            and stage2["rolled_back"]
            and stage2["active_version"] == 1
            and stage3["promoted_resumed_candidate"]
            and stage3["active_count"] == 1
            and stage3["artifact_ok"]
        ),
    }
