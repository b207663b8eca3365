"""Scheduler-side model subscription: registry → MLEvaluator scorer.

The reference intended the scheduler to call Triton over gRPC for every
evaluation (evaluator.go:84 TODO + the unwired KServe client); instead the
scheduler polls the manager registry (via dynconfig cadence) for the
active scorer version and hot-swaps the local MLEvaluator's scorer — a
pointer flip, never an RPC during scheduling.

Hot-swap atomicity (DESIGN.md §14): ``MLEvaluator.set_scorer`` is an
atomic reference flip that also re-targets the attached
``ScorerBatcher``; the evaluate path reads the scorer ONCE per call and
the batcher snapshots it ONCE per flush, so a refresh landing mid-announce
or mid-batch serves every in-flight ranking entirely from one model
version (concurrency drill: tests/test_sched_vectorized.py
refresh-under-load).  ``refresh`` itself is serialized by a lock so two
overlapping polls cannot interleave version bookkeeping.

Port of ``dragonfly2_tpu/scheduler/model_loader.py`` over the port's
``ModelRegistry`` (in process) or ``rpc.RemoteRegistry`` (the manager's
REST surface), with ``LocalRolloutClient`` or ``RolloutRESTClient`` and
the shadow replay log on disk (``shadow_log_path``) or in memory, or
over ``rpc.grpc_transport.GRPCRemoteRegistry`` (the manager's gRPC port),
as in the reference.  The installed scorers are what
``load_scorer`` returns (the numpy ``MLPScorer`` for the streaming
trainer's standardized artifacts), as in the reference.

Rollout plane (DESIGN.md §15), when a ``rollout_client`` is attached:

- the same poll also fetches the CANDIDATE version (registry state
  SHADOW/CANARY) and installs a ``ShadowScorer`` — and, in the canary
  phase, a ``CanaryRoute`` — on the evaluator;
- **digest refusal**: artifacts are verified against the sha256 the
  registry recorded at create_model (``ModelRegistry.load_artifact``); a
  mismatch logs and KEEPS the current scorer — a corrupted blob can
  demote serving quality, never scheduling itself;
- **pin on manager loss**: a failed poll drops canary routing and
  shadow scoring and keeps serving the last ACTIVE scorer.  The pin is
  sticky until a poll SUCCEEDS (no flapping); a re-appearing candidate
  of the same version re-attaches the parked shadow engine with its
  counters intact;
- **poll jitter**: each wait is ``interval · (1 ± jitter)`` drawn from
  an RNG seeded by (scheduler_id, model_name), so a fleet of schedulers
  booted together never synchronizes into a registry thundering herd,
  while any single scheduler's schedule stays reproducible.

Regional model keys (DESIGN.md §29), when an ``idc`` is configured: the
lifecycle plane registers per-region specializations under the composed
name ``model_name@idc`` next to the fleet-wide global arm.  Every poll
asks for the idc-scoped name FIRST and falls back to the global name —
so a region with a promoted specialization serves it, and every other
region keeps serving the global model (no cross-region bleed: a
subscriber only ever requests its own two names).  Versions are
per-(scheduler_id, name) registry keys, so the subscriber tracks the
NAME its loaded/candidate versions belong to and never compares version
numbers across keys; the pin above likewise pins to the last ACTIVE of
whichever key was serving.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import TYPE_CHECKING, Optional, Union

from ..manager.registry import ModelRegistry
from . import metrics
from .evaluator import CanaryRoute, MLEvaluator

if TYPE_CHECKING:  # wiring-time registry/rollout arms (no runtime import cycle)
    from ..rollout.client import LocalRolloutClient, RolloutRESTClient
    from ..rpc.grpc_transport import GRPCRemoteRegistry
    from ..rpc.registry_client import RemoteRegistry

logger = logging.getLogger(__name__)


class ModelSubscriber:
    def __init__(
        self,
        registry: "Union[ModelRegistry, RemoteRegistry, GRPCRemoteRegistry]",
        evaluator: MLEvaluator,
        *,
        scheduler_id: str,
        model_name: str = "parent-bandwidth-mlp",
        idc: Optional[str] = None,
        refresh_interval: float = 300.0,
        jitter: float = 0.1,
        rollout_client: "Optional[Union[LocalRolloutClient, RolloutRESTClient]]" = None,
        shadow_sample_rate: float = 0.1,
        shadow_log_path: Optional[str] = None,
    ) -> None:
        from ..lifecycle.arbiter import regional_model_name

        self.registry = registry
        self.evaluator = evaluator
        self.scheduler_id = scheduler_id
        self.model_name = model_name
        self.idc = idc or None
        # Poll order: idc-scoped specialization first, global fallback.
        self._names = (
            (regional_model_name(model_name, self.idc), model_name)
            if self.idc
            else (model_name,)
        )
        self.refresh_interval = refresh_interval
        self.jitter = max(0.0, float(jitter))
        self.rollout_client = rollout_client
        self.shadow_sample_rate = shadow_sample_rate
        self.shadow_log_path = shadow_log_path
        self._loaded_version: Optional[int] = None
        self._loaded_key: Optional[str] = None
        self._candidate_version: Optional[int] = None
        self._candidate_key: Optional[str] = None
        self._candidate_scorer = None
        self._shadow = None
        self._pinned = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Guards the version bookkeeping + evaluator installs ONLY — it is
        # never held across the registry/rollout polls: refresh
        # snapshots state, polls the network unlocked, then commits under
        # the lock.  `_refresh_gen` makes commits first-poll-wins: an
        # overlapping poll that lost the race discards its fetch instead
        # of installing stale versions out of order.
        self._refresh_mu = threading.Lock()
        self._refresh_gen = 0
        # Seeded per (scheduler, model, idc): deterministic for THIS
        # instance, decorrelated across a fleet (the anti-thundering-herd
        # draw).  The idc-less seed string is unchanged so existing
        # deployments keep their schedules.
        seed = f"{scheduler_id}:{model_name}"
        if self.idc:
            seed += f"@{self.idc}"
        self._rng = random.Random(seed)

    @property
    def candidate_name(self) -> str:
        """Registry name of the candidate currently under evaluation —
        the scoped name when a regional specialization is in flight.
        Reports must target THIS key or the controller would judge the
        wrong rollout row."""
        with self._refresh_mu:
            return self._candidate_key or self.model_name

    @property
    def pinned(self) -> bool:
        """True while the last poll failed (serving pinned to the last
        ACTIVE version)."""
        with self._refresh_mu:
            return self._pinned

    def _next_interval(self) -> float:
        if not self.jitter:
            return self.refresh_interval
        return self.refresh_interval * (
            1.0 + self._rng.uniform(-self.jitter, self.jitter)
        )

    def refresh(self) -> bool:
        """Pull the active (and candidate) version if changed; returns
        True on an active-scorer swap.  Safe against concurrent callers
        and against RPC threads mid-``score`` (the evaluator/batcher
        snapshot the scorer).  The registry/rollout RPCs run with NO lock
        held — state is snapshotted first and the results commit under
        ``_refresh_mu`` only if no other poll committed in between
        (first-poll-wins; the loser's fetch is discarded).  A failed poll
        PINS the evaluator to the last ACTIVE version (canary + shadow
        detached) instead of raising — scheduling never depends on
        manager liveness."""
        with self._refresh_mu:
            gen = self._refresh_gen
            loaded = (self._loaded_key, self._loaded_version)
            candidate = (self._candidate_key, self._candidate_version)
        # ---- network phase: registry + rollout polls, artifact loads ----
        try:
            active = self._fetch_active(loaded)
        except Exception as exc:  # noqa: BLE001 — manager outage → pin
            with self._refresh_mu:
                self._pin_locked(exc)
            return False
        candidate_state = candidate_exc = None
        try:
            candidate_state = self._fetch_candidate(candidate)
        except Exception as exc:  # noqa: BLE001 — candidate poll is best-effort
            candidate_exc = exc
        # ---- commit phase: bookkeeping + evaluator installs, locked ----
        with self._refresh_mu:
            if gen != self._refresh_gen:
                # A concurrent poll committed while we were on the wire;
                # its snapshot is at least as fresh as ours.
                return False
            self._refresh_gen += 1
            changed = self._commit_active_locked(active)
            if candidate_exc is not None:
                self._pin_locked(candidate_exc)
            else:
                self._commit_candidate_locked(candidate_state)
            return changed

    def _fetch_active(self, loaded):
        """Network half of the active-model poll (no lock held): returns
        ``("deactivate"|"unchanged"|"load_failed", model, scorer)``.
        Tries the idc-scoped name first, then the global fallback; the
        first ACTIVE found wins.  A failed scoped poll raises (→ pin);
        ``None`` falls through to the next name."""
        model = None
        for name in self._names:
            model = self.registry.active_model(self.scheduler_id, name)
            if model is not None:
                break
        if model is None:
            return ("deactivate", None, None)
        if (model.name, model.version) == loaded:
            return ("unchanged", model, None)
        from ..trainer.export import load_scorer

        try:
            # load_artifact verifies the recorded sha256 (ArtifactDigestError
            # on mismatch): a corrupted/swapped blob is REFUSED here and the
            # current scorer keeps serving.
            scorer = load_scorer(self.registry.load_artifact(model))
        except Exception:  # noqa: BLE001 — a bad artifact must not break scheduling
            logger.exception("loading model %s failed; keeping current scorer", model.id)
            return ("load_failed", model, None)
        return ("swap", model, scorer)

    def _commit_active_locked(self, active) -> bool:
        kind, model, scorer = active
        if kind == "deactivate":
            if self._loaded_version is not None:
                self.evaluator.set_scorer(None)  # deactivated → rule fallback
                self._loaded_version = None
                self._loaded_key = None
                return True
            return False
        if kind != "swap" or (
            model.name == self._loaded_key and model.version == self._loaded_version
        ):
            return False
        self.evaluator.set_scorer(scorer)
        self._loaded_version = model.version
        self._loaded_key = model.name
        logger.info("ML evaluator now serving %s v%d", model.name, model.version)
        return True

    # -- rollout candidate (shadow / canary) ---------------------------------

    def _fetch_candidate(self, candidate):
        """Network half of the candidate poll (no lock held): returns
        ``None`` (no rollout client) or ``("drop"|"install"|"keep"|"same",
        info, scorer)``.  Raises on a failed poll — the caller pins.
        Same idc-scoped-then-global name order as the active poll, so a
        region shadow-scores its own specialization when one is in
        flight and the global candidate otherwise."""
        if self.rollout_client is None:
            return None
        info = None
        for name in self._names:
            info = self.rollout_client.candidate(self.scheduler_id, name)
            if info is not None:
                break
        if info is None:
            return ("drop", None, None)
        if (info.model.name, info.model.version) != candidate:
            from ..trainer.export import load_scorer

            try:
                scorer = load_scorer(self.registry.load_artifact(info.model))
            except Exception:  # noqa: BLE001 — refuse the candidate, keep serving
                logger.exception(
                    "loading candidate %s failed; rollout state unchanged",
                    info.model.id,
                )
                return ("keep", info, None)
            return ("install", info, scorer)
        return ("same", info, None)

    def _commit_candidate_locked(self, candidate) -> None:
        if candidate is None:
            return
        kind, info, scorer = candidate
        if self._pinned:
            self._pinned = False
            logger.info("manager poll recovered; rollout state unpinned")
        if kind == "drop":
            self._drop_candidate_locked()
            return
        if kind == "keep":
            return
        if kind == "install" and (
            info.model.name != self._candidate_key
            or info.model.version != self._candidate_version
        ):
            from ..rollout.shadow import ShadowScorer

            if self._shadow is not None:
                self._shadow.close()
            self._shadow = ShadowScorer(
                scorer,
                candidate_version=info.model.version,
                active_version=self._loaded_version or 0,
                sample_rate=self.shadow_sample_rate,
                log_path=self.shadow_log_path,
            )
            self._candidate_scorer = scorer
            self._candidate_version = info.model.version
            self._candidate_key = info.model.name
            logger.info(
                "shadow scoring %s v%d against active v%s",
                info.model.name, info.model.version, self._loaded_version,
            )
        elif self._shadow is not None:
            # Same candidate; keep the engine but track active swaps.
            self._shadow.active_version = self._loaded_version or 0
        self.evaluator.set_shadow(self._shadow)
        if info.phase == "canary" and info.canary_percent > 0:
            canary = self.evaluator.canary
            if (
                canary is None
                or canary.version != self._candidate_version
                or canary.percent != info.canary_percent
            ):
                self.evaluator.set_canary(
                    CanaryRoute(
                        self._candidate_scorer,
                        info.canary_percent,
                        self._candidate_version,
                    )
                )
                logger.info(
                    "canary serving %s v%d at %d%%",
                    self.model_name, self._candidate_version, info.canary_percent,
                )
            metrics.ROLLOUT_SERVING_STATE.set(3, name=self.model_name)
        else:
            self.evaluator.set_canary(None)
            metrics.ROLLOUT_SERVING_STATE.set(2, name=self.model_name)

    def _drop_candidate_locked(self) -> None:
        """Candidate gone from the registry (promoted or rolled back):
        detach + dispose the local rollout state."""
        self.evaluator.set_canary(None)
        self.evaluator.set_shadow(None)
        if self._shadow is not None:
            self._shadow.close()
            self._shadow = None
        self._candidate_scorer = None
        self._candidate_version = None
        self._candidate_key = None
        metrics.ROLLOUT_SERVING_STATE.set(0, name=self.model_name)

    def _pin_locked(self, exc: BaseException) -> None:
        """The manager is unreachable: pin serving to the last ACTIVE
        version.
        Canary routing and shadow scoring DETACH (an unverified candidate
        must not take traffic while its judge is absent) but the shadow
        engine parks — a recovered poll for the same candidate version
        re-attaches it with its counters and replay log intact."""
        had_rollout = (
            self.evaluator.canary is not None or self.evaluator.shadow is not None
        )
        self.evaluator.set_canary(None)
        self.evaluator.set_shadow(None)
        metrics.ROLLOUT_SERVING_STATE.set(0, name=self.model_name)
        if not self._pinned:
            self._pinned = True
            if had_rollout:
                logger.warning(
                    "model poll failed (%s); pinned to last ACTIVE v%s — "
                    "canary/shadow detached until the manager returns",
                    exc, self._loaded_version,
                )
            else:
                logger.warning(
                    "model poll failed (%s); keeping scorer v%s",
                    exc, self._loaded_version,
                )

    def serve(self) -> None:
        if self._thread is not None:
            return
        self.refresh()

        def loop() -> None:
            while not self._stop.wait(self._next_interval()):
                try:
                    self.refresh()
                except Exception:  # noqa: BLE001
                    logger.exception("model refresh failed")

        self._thread = threading.Thread(target=loop, name="model-subscriber", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._shadow is not None:
            self._shadow.close()
