"""Rollout-plane client: how a scheduler talks to the rollout controller.

Port of ``dragonfly2_tpu/rollout/client.py``, in-process half.  One small
surface:

- ``candidate(scheduler_id, name)`` — the version under evaluation (a
  ``CandidateInfo`` with the model row, rollout phase and canary
  percent), or None;
- ``report(scheduler_id, name, payload)`` — post one evaluation report
  (rollout/evaluation.py ``evaluate_shadow`` output) and get the
  controller's decision back;
- ``begin(model_id)`` — start the evidence-gated rollout for a freshly
  registered version (CANDIDATE → SHADOW), the lifecycle daemon's
  zero-human entry into the promotion plane (lifecycle/daemon.py).

``LocalRolloutClient`` wraps an in-process ``RolloutController``.  The
REST client (``RolloutRESTClient``) is ROADMAP queue 1 item 12b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..manager.registry import Model


@dataclass
class CandidateInfo:
    model: Model
    phase: str                # "shadow" | "canary"
    canary_percent: int


class LocalRolloutClient:
    """In-process controller + registry (same process as the manager)."""

    def __init__(self, controller) -> None:
        self.controller = controller
        self.registry = controller.registry

    def candidate(self, scheduler_id: str, name: str) -> Optional[CandidateInfo]:
        model = self.registry.candidate_model(scheduler_id, name)
        if model is None:
            return None
        rollout = self.controller.get(scheduler_id, name)
        return CandidateInfo(
            model=model,
            phase=model.state.value,
            canary_percent=rollout.canary_percent if rollout else 0,
        )

    def report(self, scheduler_id: str, name: str, payload: dict) -> dict:
        return self.controller.report(scheduler_id, name, payload)

    def begin(self, model_id: str, *, canary_percent: Optional[int] = None) -> dict:
        return self.controller.to_json(
            self.controller.begin(model_id, canary_percent=canary_percent)
        )

    def load_artifact(self, model: Model) -> bytes:
        return self.registry.load_artifact(model)
