"""Self-driving model lifecycle plane (DESIGN.md §29).

Port of ``dragonfly2_tpu/lifecycle/daemon.py``.  The daemon's trainers
are the port's ``StreamingTrainer`` on ``device``.  The
``lifecycle/epoch`` and ``lifecycle/promote`` spans wait for the port's
tracing (ROADMAP queue 1 item 10).

The LifecycleDaemon closes the loop the reference left as TODOs
(trainGNN/trainMLP): it streams live download records into per-key
``StreamingTrainer`` instances, cuts training epochs at a configurable
record cadence, exports each epoch's scorer blob WITH the stamped
``train_bin_edges``/``train_bin_fracs`` drift baseline, registers it as a
CANDIDATE through the HA-failover-aware registry client, enters it into
the guardrailed rollout plane (``rollout_client.begin``), and then pumps
replay evaluations so the existing ``RolloutController`` walks it
SHADOW → CANARY → ACTIVE with zero human steps — injected regressions
roll back on the controller's guardrails exactly like operator-driven
rollouts.

Per-region specialization: every configured region trains its own arm
(registry key ``name@region``) alongside the fleet-wide global arm;
before ANY candidate may enter CANARY the pure arbiter
(lifecycle/arbiter.py, a declared DF018 replay root) compares
global-vs-regional regret@k — losers are retired, winners' reports are
forwarded to the controller.

Durability: epoch watermarks, candidate lineage and promotion history
persist in the DF014-checked ``lifecycle`` StateBackend namespace
(lifecycle/state.py) — on the replicated backend a manager bounce
mid-promotion RESUMES (the controller's ``_reconcile`` repairs rollout
rows, the store hands the daemon its watermarks and in-flight candidate
back) instead of restarting the loop.  Without a backend the store runs
in-memory: the cadence contract (epoch every ``epoch_records`` NEW
records) still holds for the life of the process — that is the trainer
CLI wiring, which has no StateBackend of its own.

Every decision is computed in lifecycle/arbiter.py pure functions; the
daemon only samples the world (record counters, replay logs) and carries
the verdicts out.  The ``lifecycle.register``/``lifecycle.report`` fault
seams (utils/faultinject.py) let the chaos drills cut the train→serve
plane at its two network edges.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..utils import faultinject
from . import metrics
from .arbiter import GLOBAL_KEY, arbitrate_candidates, plan_epoch, regional_model_name
from .state import LifecycleStore

logger = logging.getLogger(__name__)


@dataclass
class LifecycleConfig:
    scheduler_id: str = "scheduler-local"
    model_name: str = "parent-bandwidth-mlp"
    # Regional arms trained alongside the global one; each serves
    # ``model_name@region`` to that region's schedulers.
    regions: Tuple[str, ...] = ()
    # Cadence: cut an epoch every ``epoch_records`` new records per key.
    epoch_records: int = 1024
    max_steps_per_epoch: int = 50
    min_joined: int = 50              # arbitration evidence floor
    arbitration_margin: float = 0.02  # regional must beat global by this
    canary_percent: int = 10
    regret_k: int = 4
    interval_s: float = 30.0          # serve-loop cadence
    trainer_batch_size: int = 256
    trainer_snapshot_rows: int = 2048
    model_type: str = "mlp"


# replay_source(key) -> None | (shadow_rows, download_rows[, psi_max]):
# the daemon's read side of the DFC1 shadow/replay plane.  Deployments
# plug the scheduler's shadow logs + record store; sim plugs synthetic
# generators.
ReplaySource = Callable[[str], Optional[tuple]]


class LifecycleDaemon:
    def __init__(
        self,
        registry,
        rollout_client,
        *,
        config: Optional[LifecycleConfig] = None,
        backend=None,
        trainer_factory: Optional[Callable[[str], object]] = None,
        replay_source: Optional[ReplaySource] = None,
        export_transform: Optional[Callable] = None,
        device="cuda",
    ) -> None:
        self.registry = registry
        # Where the default trainers train (a trainer_factory decides for
        # its own trainers).
        self.device = device
        self.client = rollout_client
        self.config = config or LifecycleConfig()
        # backend=None → in-memory rows: watermarks/lineage still advance
        # (the cadence contract needs them) but die with the process.
        self.store = LifecycleStore(backend)
        self.replay_source = replay_source
        # Chaos/drill hook: transforms the exported scorer before it is
        # registered (sim/lifecycle.py injects an inverted head through
        # it).  Production wiring leaves it None.
        self.export_transform = export_transform
        self._keys: Tuple[str, ...] = (GLOBAL_KEY,) + tuple(self.config.regions)
        factory = trainer_factory or self._default_trainer
        self._trainers = {key: factory(key) for key in self._keys}
        self._mu = threading.Lock()
        self._records: Dict[str, int] = {}
        self._dropped: Dict[str, int] = {}
        for key in self._keys:
            # Un-flushed feeds die with the process; cadence restarts
            # from the persisted watermark.
            self._records[key] = int(self.store.row(key).get("watermark", 0))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _default_trainer(self, key: str):
        from ..trainer.streaming import StreamingConfig, StreamingTrainer

        return StreamingTrainer(
            StreamingConfig(
                batch_size=self.config.trainer_batch_size,
                snapshot_rows=self.config.trainer_snapshot_rows,
            ),
            device=self.device,
        )

    # -- identity -------------------------------------------------------------

    def keys(self) -> Tuple[str, ...]:
        return self._keys

    def model_name_for(self, key: str) -> str:
        return regional_model_name(self.config.model_name, key)

    # -- ingest ---------------------------------------------------------------

    def feed(self, rows: np.ndarray, *, region: Optional[str] = None) -> None:
        """Offer live download records: every batch trains the global arm;
        region-attributed batches ALSO train that region's arm."""
        n = int(np.asarray(rows).shape[0])
        if n == 0:
            return
        targets = [GLOBAL_KEY]
        if region and region in self._trainers:
            targets.append(region)
        for key in targets:
            if self._trainers[key].feed(rows, block=False):
                with self._mu:
                    self._records[key] = self._records.get(key, 0) + n
            else:
                # Queue full: the rows never reached the trainer, so
                # they must not advance the epoch cadence either — an
                # epoch cut on phantom records would train on an empty
                # queue and export unchanged weights.
                with self._mu:
                    self._dropped[key] = dropped = self._dropped.get(key, 0) + n
                metrics.LIFECYCLE_DROPPED_RECORDS_TOTAL.inc(
                    n, name=self.model_name_for(key)
                )
                logger.warning(
                    "lifecycle %s: trainer queue full, dropped %d rows "
                    "(%d total)", key, n, dropped,
                )

    def records_seen(self, key: str) -> int:
        with self._mu:
            return self._records.get(key, 0)

    def records_dropped(self, key: str) -> int:
        with self._mu:
            return self._dropped.get(key, 0)

    # online_sink surface (trainer/service.py): the lifecycle ingest
    # rides the same wire adapter as the online graph trainer, so every
    # chunk landing on the trainer's ingest servers also streams here.
    def feed_download_rows(self, rows: np.ndarray) -> None:
        self.feed(rows)

    def feed_topology_rows(self, rows: np.ndarray) -> None:
        """Topology rows don't train the MLP lifecycle (the GNN arm
        consumes them in a later round)."""

    # -- training epochs ------------------------------------------------------

    def _candidate_in_flight(self, key: str) -> bool:
        model = self.registry.candidate_model(
            self.config.scheduler_id, self.model_name_for(key)
        )
        return model is not None

    def maybe_epoch(self, key: str) -> Optional[dict]:
        """Cut one training epoch for ``key`` if the cadence decision
        (arbiter.plan_epoch, a replay root) says so."""
        row = self.store.row(key)
        try:
            in_flight = self._candidate_in_flight(key)
        except Exception as exc:  # noqa: BLE001 — manager outage: retry next cycle
            logger.warning("lifecycle %s: candidate poll failed: %s", key, exc)
            return None
        plan = plan_epoch(
            records_seen=self.records_seen(key),
            watermark=int(row.get("watermark", 0)),
            epoch_records=self.config.epoch_records,
            candidate_in_flight=in_flight,
        )
        if not plan["train"]:
            return None
        return self.run_epoch(key, watermark=int(plan["watermark"]))

    def run_epoch(self, key: str, *, watermark: int) -> Optional[dict]:
        """train → export(+drift baseline) → register CANDIDATE → begin
        rollout, as one epoch."""
        from ..trainer.export import scorer_to_bytes

        cfg = self.config
        name = self.model_name_for(key)
        epoch = int(self.store.row(key).get("epoch", 0)) + 1
        t0 = time.monotonic()
        trainer = self._trainers[key]
        # trainer.step is cumulative across epochs — only THIS
        # call's step count says whether the epoch trained anything.
        steps = trainer.run(max_steps=cfg.max_steps_per_epoch, idle_timeout=0.01)
        if steps == 0:
            # Not enough queued rows for one full batch yet: leave
            # the watermark so the cadence re-fires once they land,
            # instead of exporting unchanged weights.
            logger.info("lifecycle %s: no full batch yet; epoch deferred", key)
            return None
        scorer = trainer.export_scorer()
        if self.export_transform is not None:
            scorer = self.export_transform(scorer, key, epoch)
        try:
            faultinject.fire("lifecycle.register")
            model = self.registry.create_model(
                name=name,
                type=cfg.model_type,
                scheduler_id=cfg.scheduler_id,
                artifact=scorer_to_bytes(scorer),
                evaluation={"records_seen": float(trainer.records_seen)},
            )
            self.client.begin(model.id, canary_percent=cfg.canary_percent)
        except Exception as exc:  # noqa: BLE001 — retry on the next cycle
            logger.warning("lifecycle %s: register/begin failed: %s", key, exc)
            return None
        self.store.update(
            key,
            epoch=epoch,
            watermark=watermark,
            candidate_id=model.id,
            candidate_version=model.version,
        )
        self.store.append_history(
            key,
            {"epoch": epoch, "event": "registered",
             "model_id": model.id, "version": model.version},
        )
        metrics.LIFECYCLE_EPOCHS_TOTAL.inc(name=name)
        metrics.LIFECYCLE_EPOCH_SECONDS.observe(time.monotonic() - t0)
        logger.info(
            "lifecycle %s: epoch %d registered %s v%d → shadow",
            key, epoch, model.id, model.version,
        )
        return {"key": key, "epoch": epoch, "model_id": model.id,
                "version": model.version}

    # -- rollout pump ---------------------------------------------------------

    def _resolve_candidate(self, key: str, row: dict) -> None:
        """The in-flight candidate disappeared from the registry: record
        how it resolved (promoted by the controller, or rolled back) so
        lineage survives a manager bounce the daemon never witnessed."""
        if not row.get("candidate_id"):
            return
        try:
            active = self.registry.active_model(
                self.config.scheduler_id, self.model_name_for(key)
            )
        except Exception as exc:  # noqa: BLE001 — resolve on a later cycle
            logger.warning("lifecycle %s: lineage resolve failed: %s", key, exc)
            return
        outcome = (
            "promoted"
            if active is not None and active.id == row["candidate_id"]
            else "rolled_back"
        )
        self.store.append_history(
            key,
            {"epoch": int(row.get("epoch", 0)), "event": outcome,
             "model_id": row["candidate_id"],
             "version": int(row.get("candidate_version", 0))},
        )
        self.store.update(key, candidate_id="", candidate_version=0)

    def pump_rollouts(self) -> List[dict]:
        """One evaluate → arbitrate → report sweep over every key with a
        candidate in flight.  SHADOW candidates pass the regret@k
        arbitration gate before their reports reach the controller
        (i.e. before they may enter CANARY); CANARY/ACTIVE candidates
        report unconditionally — the guardrail watch must keep judging
        them."""
        cfg = self.config
        infos: Dict[str, object] = {}
        reports: Dict[str, dict] = {}
        for key in self._keys:
            name = self.model_name_for(key)
            row = self.store.row(key)
            try:
                info = self.client.candidate(cfg.scheduler_id, name)
            except Exception as exc:  # noqa: BLE001 — manager outage
                logger.warning("lifecycle %s: candidate poll failed: %s", key, exc)
                continue
            if info is None:
                self._resolve_candidate(key, row)
                continue
            src = self.replay_source(key) if self.replay_source else None
            if src is None:
                continue
            shadow_rows, download_rows = src[0], src[1]
            psi_max = src[2] if len(src) > 2 else None
            if not shadow_rows.shape[0]:
                continue
            from ..rollout.evaluation import evaluate_shadow

            infos[key] = info
            reports[key] = evaluate_shadow(
                shadow_rows, download_rows, k=cfg.regret_k, psi_max=psi_max
            )
        if not reports:
            return []
        shadow_reports = {
            key: rep
            for key, rep in reports.items()
            if getattr(infos[key], "phase", "") == "shadow"
        }
        verdict = arbitrate_candidates(
            shadow_reports,
            min_joined=cfg.min_joined,
            margin=cfg.arbitration_margin,
        )
        return self._apply(reports, infos, verdict)

    def _apply(self, reports, infos, verdict) -> List[dict]:
        cfg = self.config
        outcomes: List[dict] = []
        to_report = [
            key
            for key in sorted(reports)
            if key in verdict["advance"]
            or getattr(infos[key], "phase", "") != "shadow"
        ]
        for key, reason in sorted(verdict["retire"].items()):
            name = self.model_name_for(key)
            model = getattr(infos[key], "model", None)
            try:
                deactivate = getattr(self.registry, "deactivate", None)
                if deactivate is not None and model is not None:
                    deactivate(model.id)
            except Exception as exc:  # noqa: BLE001 — retire on a later cycle
                logger.warning("lifecycle %s: retire failed: %s", key, exc)
                continue
            row = self.store.row(key)
            self.store.append_history(
                key,
                {"epoch": int(row.get("epoch", 0)),
                 "event": "arbitration_retired", "reason": reason,
                 "model_id": row.get("candidate_id", "")},
            )
            self.store.update(key, candidate_id="", candidate_version=0)
            metrics.LIFECYCLE_ROLLBACKS_TOTAL.inc(name=name)
            outcomes.append({"key": key, "decision": "retired", "reason": reason})
            logger.info("lifecycle %s: candidate retired by arbitration: %s",
                        key, reason)
        for key in to_report:
            name = self.model_name_for(key)
            try:
                faultinject.fire("lifecycle.report")
                decision = self.client.report(
                    cfg.scheduler_id, name, reports[key]
                )
            except KeyError:
                # Registered candidate with no rollout row yet (a crash
                # between create_model and begin): re-enter it.
                try:
                    model = getattr(infos[key], "model", None)
                    if model is not None:
                        self.client.begin(
                            model.id, canary_percent=cfg.canary_percent
                        )
                except Exception as exc:  # noqa: BLE001
                    logger.warning("lifecycle %s: re-begin failed: %s", key, exc)
                continue
            except Exception as exc:  # noqa: BLE001 — manager outage
                logger.warning("lifecycle %s: report failed: %s", key, exc)
                continue
            outcome = {"key": key, "decision": decision.get("decision"),
                       "phase": decision.get("phase"),
                       "reason": decision.get("reason", "")}
            outcomes.append(outcome)
            row = self.store.row(key)
            if decision.get("decision") in ("advance", "promote", "rollback"):
                self.store.append_history(
                    key,
                    {"epoch": int(row.get("epoch", 0)),
                     "event": decision.get("decision"),
                     "phase": decision.get("phase"),
                     "model_id": row.get("candidate_id", "")},
                )
            if decision.get("decision") in ("promote", "rollback"):
                self.store.update(key, candidate_id="", candidate_version=0)
            if decision.get("decision") == "promote":
                metrics.LIFECYCLE_PROMOTIONS_TOTAL.inc(name=name)
            elif decision.get("decision") == "rollback":
                metrics.LIFECYCLE_ROLLBACKS_TOTAL.inc(name=name)
        return outcomes

    # -- loop -----------------------------------------------------------------

    def step(self) -> dict:
        """One full lifecycle cycle: cadence-gated epochs for every key,
        then the evaluate→arbitrate→report pump."""
        epochs = []
        for key in self._keys:
            res = self.maybe_epoch(key)
            if res is not None:
                epochs.append(res)
        return {"epochs": epochs, "reports": self.pump_rollouts()}

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001
                    logger.exception("lifecycle cycle failed")

        self._thread = threading.Thread(
            target=loop, name="lifecycle-daemon", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


def file_replay_source(
    shadow_paths: Dict[str, List[str]], download_paths: List[str]
) -> ReplaySource:
    """Deployment read side: per-key DFC1 shadow replay shards joined
    against the record store's download shards (the same loaders the
    RolloutReporter uses)."""
    from ..rollout.evaluation import load_replay_rows

    def source(key: str):
        paths = shadow_paths.get(key)
        if not paths:
            return None
        shadow_rows = load_replay_rows(paths)
        download_rows = load_replay_rows(download_paths)
        return shadow_rows, download_rows

    return source
