"""Scheduler-side rollout reporter: turn the replay log into reports.

Port of ``dragonfly2_tpu/rollout/reporter.py``, verbatim.  Owns the
evaluate-and-report cycle: drain the shadow worker, read the replay
log, join it against the record store's completed Downloads (the
realized outcomes), compute both arms' ranking quality
(rollout/evaluation.py), post the report through the rollout client,
and apply whatever the controller decided by refreshing the model
subscriber (which installs/uninstalls shadow and canary state on the
evaluator).  Tests and drills drive ``run_once`` synchronously; the CLI
runs ``serve`` on an interval thread.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from .evaluation import evaluate_shadow, load_replay_rows

logger = logging.getLogger(__name__)


class RolloutReporter:
    def __init__(
        self,
        subscriber,
        storage,
        client,
        *,
        interval_s: float = 60.0,
        regret_k: int = 4,
    ) -> None:
        self.subscriber = subscriber
        self.storage = storage
        self.client = client
        self.interval_s = interval_s
        self.regret_k = regret_k
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> Optional[dict]:
        """One evaluate→report→apply cycle; returns {report, decision}
        or None when there is nothing to report (no shadow installed, no
        rollout registered, or the manager is unreachable — the
        subscriber's own poll handles pinning in that last case)."""
        shadow = getattr(self.subscriber.evaluator, "shadow", None)
        if shadow is None:
            return None
        shadow.drain()
        shadow_rows = shadow.replay_rows()
        if not shadow_rows.shape[0]:
            return None
        download_rows = load_replay_rows(self.storage.download_columnar_paths())
        psi = shadow.psi()
        report = evaluate_shadow(
            shadow_rows,
            download_rows,
            k=self.regret_k,
            psi_max=float(psi.max()) if psi is not None and psi.size else None,
        )
        report["shadow"] = shadow.stats()
        # Report against the key actually under evaluation: with an
        # idc-scoped subscriber the candidate may be the regional
        # specialization (model_loader.candidate_name), whose rollout
        # row the controller keys by the composed name.
        report_name = getattr(
            self.subscriber, "candidate_name", self.subscriber.model_name
        )
        try:
            decision = self.client.report(
                self.subscriber.scheduler_id, report_name, report
            )
        except KeyError:
            logger.debug("no rollout registered for this candidate yet")
            return None
        except Exception as exc:  # noqa: BLE001 — manager outage: report next cycle
            logger.warning("rollout report failed: %s", exc)
            return None
        # Apply the decision: the subscriber's candidate poll moves the
        # evaluator between shadow/canary/active/none states.
        self.subscriber.refresh()
        return {"report": report, "decision": decision}

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001
                    logger.exception("rollout report cycle failed")

        self._thread = threading.Thread(
            target=loop, name="rollout-reporter", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
