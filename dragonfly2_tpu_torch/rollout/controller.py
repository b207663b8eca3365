"""Rollout controller: evidence-gated promotion with automatic rollback.

Port of ``dragonfly2_tpu/rollout/controller.py``, with its
``rollout/transition`` spans.

The registry alone moves a version from CREATE straight to ACTIVE on
operator say-so.  This controller inserts the gates: a per
(scheduler_id, name) state machine

    CANDIDATE → SHADOW → CANARY(p%) → ACTIVE
                  ↓          ↓          ↓
              ROLLED_BACK (candidate deactivated / last-good re-activated)

driven entirely by the scheduler's shadow/canary evaluation reports
(rollout/evaluation.py payloads posted through rollout/client.py).
Guardrails are explicit and configurable: a minimum joined-sample count
before any judgement, a regret-ratio ceiling vs the active arm, an
inversion-rate ceiling, and a PSI drift ceiling.  Breach ⇒ rollback;
clean evidence past the sample floor ⇒ advance.  Post-promotion reports
keep being judged: a regression after ACTIVE re-activates the recorded
last-good version (``previous_active_id``) — the auto-rollback leg.

Rows persist through the manager's StateBackend (table ``rollouts``) so
a restart resumes every in-flight rollout exactly where it was, and the
``rollout_state`` gauge (rollout/metrics.py) mirrors each machine for
scrapes and drills.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

from ..manager.registry import ModelState

if TYPE_CHECKING:  # wiring-time types (no runtime import cycle)
    from ..manager.registry import ModelRegistry
    from ..manager.state import StateBackend
from . import metrics

logger = logging.getLogger(__name__)


class RolloutPhase(str, enum.Enum):
    SHADOW = "shadow"
    CANARY = "canary"
    ACTIVE = "active"
    ROLLED_BACK = "rolled_back"


@dataclass
class RolloutGuardrails:
    """Promotion/rollback thresholds (config: manager rollout section)."""

    min_shadow_samples: int = 200      # joined edges before any shadow verdict
    min_canary_samples: int = 200      # further joined edges in canary
    max_regret_ratio: float = 1.10     # candidate regret ≤ active·ratio + slack
    regret_slack: float = 0.02         # absolute slack (both regrets near 0)
    max_inversion_ratio: float = 1.10  # same shape for pairwise inversions
    max_psi: float = 0.25              # industry-standard "significant shift"
    canary_percent: int = 10           # % of announces bucketed to candidate


@dataclass
class Rollout:
    """One (scheduler_id, name) rollout row."""

    scheduler_id: str
    name: str
    model_id: str
    version: int
    phase: str = RolloutPhase.SHADOW.value
    previous_active_id: str = ""       # last-good, for post-ACTIVE rollback
    canary_percent: int = 10
    reports: int = 0
    # Reports carry CUMULATIVE joined-edge counts (the reporter evaluates
    # the whole replay log); per-phase progress is measured against the
    # count captured when the phase began.
    joined_edges: int = 0
    phase_baseline: int = 0
    last_report: dict = field(default_factory=dict)
    reason: str = ""
    started_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    @property
    def key(self) -> str:
        return f"{self.scheduler_id}:{self.name}"

    def phase_samples(self) -> int:
        return max(self.joined_edges - self.phase_baseline, 0)


def _state_code(phase: str) -> int:
    return metrics.STATE_CODES.get(phase, 0)


class RolloutController:
    """The manager-side brain: owns rollout rows, judges reports, and
    drives the registry's SHADOW/CANARY/ACTIVE transitions."""

    def __init__(
        self,
        registry: "ModelRegistry",
        *,
        guardrails: Optional[RolloutGuardrails] = None,
        backend: "Optional[StateBackend]" = None,
    ) -> None:
        self.registry = registry
        self.guardrails = guardrails or RolloutGuardrails()
        self._mu = threading.RLock()
        self._rollouts: Dict[str, Rollout] = {}
        self._table = None
        if backend is not None:
            self._table = backend.table("rollouts")
            for key, doc in self._table.load_all().items():
                r = Rollout(**doc)
                self._rollouts[key] = r
                metrics.ROLLOUT_STATE.set(
                    _state_code(r.phase), scheduler_id=r.scheduler_id, name=r.name
                )
        # Crash-between-rows recovery: the registry flip and the
        # rollout row live in different tables, so a crash between the
        # two commits can leave them disagreeing.  The registry is the
        # source of truth — reconcile the rows to it on every load.
        self._reconcile()

    def _reconcile(self) -> None:
        """Repair rollout rows against the registry after a restart.

        Covers every tear a crash between the registry's transactional
        flip and the rollout-row put can leave:

        - a candidate model (SHADOW/CANARY) with NO rollout row (crash
          in ``begin``/after a lost row): the row is ADOPTED — without
          it, every evaluation report would KeyError forever;
        - a row whose model is gone (crash inside ``delete_model``
          between the child and parent deletes): the row is dropped;
        - a row whose phase disagrees with the model state (crash in
          ``_advance``/``_rollback`` after the registry commit): the
          phase follows the registry.
        """
        with self._mu:
            for key, rollout in list(self._rollouts.items()):
                model = self.registry.get(rollout.model_id)
                if model is None:
                    # Parent row deleted; drop the dangling child.
                    del self._rollouts[key]
                    if self._table is not None:
                        self._table.delete(key)
                    logger.warning(
                        "rollout %s: model %s gone; dropped dangling row",
                        key, rollout.model_id,
                    )
                    continue
                state = model.state.value
                if rollout.phase in (
                    RolloutPhase.SHADOW.value, RolloutPhase.CANARY.value,
                    RolloutPhase.ACTIVE.value,
                ) and rollout.phase != state:
                    if state in (
                        RolloutPhase.SHADOW.value, RolloutPhase.CANARY.value,
                        RolloutPhase.ACTIVE.value,
                    ):
                        # The registry committed an advance the row missed.
                        rollout.phase = state
                        rollout.phase_baseline = rollout.joined_edges
                        rollout.reason = "phase reconciled to registry after restart"
                    else:
                        # Candidate was demoted (rollback committed to the
                        # registry only).
                        rollout.phase = RolloutPhase.ROLLED_BACK.value
                        rollout.reason = (
                            "rolled back during crash recovery: registry "
                            f"shows {state!r}"
                        )
                    self._persist(rollout)
                    logger.warning("rollout %s: %s", key, rollout.reason)
            for model in self.registry.list():
                if model.state.value not in (
                    RolloutPhase.SHADOW.value, RolloutPhase.CANARY.value,
                ):
                    continue
                key = f"{model.scheduler_id}:{model.name}"
                if key in self._rollouts and self._rollouts[key].phase != \
                        RolloutPhase.ROLLED_BACK.value:
                    continue
                previous = self.registry.active_model(
                    model.scheduler_id, model.name
                )
                adopted = Rollout(
                    scheduler_id=model.scheduler_id,
                    name=model.name,
                    model_id=model.id,
                    version=model.version,
                    phase=model.state.value,
                    previous_active_id=previous.id if previous else "",
                    canary_percent=self.guardrails.canary_percent,
                    reason="adopted during crash recovery",
                )
                self._rollouts[key] = adopted
                self._persist(adopted)
                logger.warning(
                    "rollout %s v%d: adopted orphan %s candidate after "
                    "restart", key, adopted.version, model.state.value,
                )

    def _persist(self, rollout: Rollout) -> None:
        rollout.updated_at = time.time()
        if self._table is not None:
            self._table.put(rollout.key, asdict(rollout))
        metrics.ROLLOUT_STATE.set(
            _state_code(rollout.phase),
            scheduler_id=rollout.scheduler_id,
            name=rollout.name,
        )

    # -- lifecycle ------------------------------------------------------------

    def begin(
        self, model_id: str, *, canary_percent: Optional[int] = None
    ) -> Rollout:
        """Start a rollout for a registered version: records the current
        active as last-good and flips the candidate to SHADOW."""
        with self._mu:
            model = self.registry.get(model_id)
            if model is None:
                raise KeyError(model_id)
            if model.state is ModelState.ACTIVE:
                raise ValueError(f"{model_id} is already active")
            previous = self.registry.active_model(model.scheduler_id, model.name)
            rollout = Rollout(
                scheduler_id=model.scheduler_id,
                name=model.name,
                model_id=model.id,
                version=model.version,
                previous_active_id=previous.id if previous else "",
                canary_percent=(
                    self.guardrails.canary_percent
                    if canary_percent is None
                    else int(canary_percent)
                ),
            )
            self.registry.set_state(model.id, ModelState.SHADOW)
            self._rollouts[rollout.key] = rollout
            self._persist(rollout)
            metrics.ROLLOUT_TRANSITIONS_TOTAL.inc(to=RolloutPhase.SHADOW.value)
            logger.info(
                "rollout %s v%d → shadow (last-good %s)",
                rollout.key, rollout.version, rollout.previous_active_id or "none",
            )
            return rollout

    def delete_model(self, model_id: str) -> None:
        """The ONLY legal model-delete entry (foreign key
        models→rollouts): rollout rows
        referencing the model are dropped BEFORE the registry row, so a
        crash between the two deletes leaves at worst a model without
        rollout rows — never a rollout row pointing at a deleted model
        (and even that tear is repaired by ``_reconcile`` on reload)."""
        with self._mu:
            for key, rollout in list(self._rollouts.items()):
                if rollout.model_id != model_id:
                    continue
                del self._rollouts[key]
                if self._table is not None:
                    self._table.delete(key)
                metrics.ROLLOUT_STATE.set(
                    0, scheduler_id=rollout.scheduler_id, name=rollout.name
                )
            self.registry.delete(model_id)

    def get(self, scheduler_id: str, name: str) -> Optional[Rollout]:
        with self._mu:
            return self._rollouts.get(f"{scheduler_id}:{name}")

    def list(self) -> List[Rollout]:
        with self._mu:
            return sorted(self._rollouts.values(), key=lambda r: r.key)

    # -- judgement ------------------------------------------------------------

    def _breach(self, report: dict) -> Optional[str]:
        """First guardrail the report breaches, or None."""
        g = self.guardrails
        psi = report.get("psi_max")
        if psi is not None and psi > g.max_psi:
            return f"feature drift: psi_max {psi:.3f} > {g.max_psi}"
        regret = report.get("regret_at_k") or {}
        cand, active = regret.get("candidate", 0.0), regret.get("active", 0.0)
        if cand > active * g.max_regret_ratio + g.regret_slack:
            return (
                f"regret@{regret.get('k', '?')} regression: candidate "
                f"{cand:.4f} vs active {active:.4f}"
            )
        inv = report.get("inversion_rate") or {}
        icand, iactive = inv.get("candidate", 0.0), inv.get("active", 0.0)
        if icand > iactive * g.max_inversion_ratio + g.regret_slack:
            return (
                f"inversion regression: candidate {icand:.4f} vs active "
                f"{iactive:.4f}"
            )
        return None

    def report(self, scheduler_id: str, name: str, report: dict) -> dict:
        """Judge one evaluation report; returns the decision the
        scheduler acts on: {decision, phase, canary_percent, reason}."""
        with self._mu:
            rollout = self._rollouts.get(f"{scheduler_id}:{name}")
            if rollout is None:
                raise KeyError(f"no rollout for {scheduler_id}:{name}")
            if rollout.phase == RolloutPhase.ROLLED_BACK.value:
                return self._decision(rollout, "rolled_back")
            rollout.reports += 1
            rollout.joined_edges = max(
                rollout.joined_edges, int(report.get("joined_edges", 0))
            )
            rollout.last_report = dict(report)
            g = self.guardrails
            needed = (
                g.min_canary_samples
                if rollout.phase == RolloutPhase.CANARY.value
                else g.min_shadow_samples
            )
            if rollout.phase_samples() < needed and rollout.phase != RolloutPhase.ACTIVE.value:
                self._persist(rollout)
                return self._decision(
                    rollout, "hold",
                    reason=f"{rollout.phase_samples()}/{needed} joined samples",
                )
            breach = self._breach(report)
            if breach is not None:
                self._rollback(rollout, breach)
                return self._decision(rollout, "rollback", reason=breach)
            if rollout.phase == RolloutPhase.SHADOW.value:
                self._advance(rollout, RolloutPhase.CANARY)
                return self._decision(rollout, "advance")
            if rollout.phase == RolloutPhase.CANARY.value:
                self._advance(rollout, RolloutPhase.ACTIVE)
                return self._decision(rollout, "promote")
            # Already ACTIVE and still clean: keep watching.
            self._persist(rollout)
            return self._decision(rollout, "hold", reason="post-promotion watch")

    def _decision(self, rollout: Rollout, decision: str, reason: str = "") -> dict:
        metrics.ROLLOUT_REPORTS_TOTAL.inc(decision=decision)
        return {
            "decision": decision,
            "phase": rollout.phase,
            "model_id": rollout.model_id,
            "version": rollout.version,
            "canary_percent": rollout.canary_percent,
            "reason": reason or rollout.reason,
        }

    def _advance(self, rollout: Rollout, to: RolloutPhase) -> None:
        from ..utils.tracing import default_tracer

        # Transition span: controller decisions are exactly the moments
        # an operator wants on the flight recorder next to the request
        # that triggered them (DESIGN.md §21).
        with default_tracer.span(
            "rollout/transition",
            scheduler_id=rollout.scheduler_id, model_name=rollout.name,
            from_phase=rollout.phase, to_phase=to.value,
            version=rollout.version,
        ):
            if to is RolloutPhase.CANARY:
                self.registry.set_state(rollout.model_id, ModelState.CANARY)
            elif to is RolloutPhase.ACTIVE:
                # activate() owns the single-active flip (old active →
                # INACTIVE, candidate → ACTIVE) in one persisted
                # transaction.
                self.registry.activate(rollout.model_id)
            rollout.phase = to.value
            rollout.phase_baseline = rollout.joined_edges
            self._persist(rollout)
        metrics.ROLLOUT_TRANSITIONS_TOTAL.inc(to=to.value)
        logger.info("rollout %s v%d → %s", rollout.key, rollout.version, to.value)

    def _rollback(self, rollout: Rollout, reason: str) -> None:
        from ..utils.tracing import default_tracer

        with default_tracer.span(
            "rollout/transition",
            scheduler_id=rollout.scheduler_id, model_name=rollout.name,
            from_phase=rollout.phase,
            to_phase=RolloutPhase.ROLLED_BACK.value,
            version=rollout.version, reason=reason,
        ):
            self._rollback_traced(rollout, reason)

    def _rollback_traced(self, rollout: Rollout, reason: str) -> None:
        promoted = rollout.phase == RolloutPhase.ACTIVE.value
        if promoted and rollout.previous_active_id:
            # The regression shipped: re-activate the recorded last-good
            # (one transactional flip demotes the bad version).
            try:
                self.registry.activate(rollout.previous_active_id)
            except KeyError:
                # Last-good deleted since: all we can do is demote.
                logger.warning(
                    "rollout %s: last-good %s gone; deactivating %s only",
                    rollout.key, rollout.previous_active_id, rollout.model_id,
                )
                self.registry.set_state(rollout.model_id, ModelState.INACTIVE)
        else:
            self.registry.set_state(rollout.model_id, ModelState.INACTIVE)
        rollout.phase = RolloutPhase.ROLLED_BACK.value
        rollout.reason = reason
        self._persist(rollout)
        metrics.ROLLOUT_TRANSITIONS_TOTAL.inc(to=RolloutPhase.ROLLED_BACK.value)
        logger.warning(
            "rollout %s v%d ROLLED BACK: %s", rollout.key, rollout.version, reason
        )

    def to_json(self, rollout: Rollout) -> dict:
        return asdict(rollout)
