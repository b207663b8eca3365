"""SLO autopilot: burn-rate verdicts feed back into admission
(DESIGN.md §26; closes the §23 telemetry loop the ROADMAP asked for).

The loop: a declared latency SLO (``telemetry.slos``) burns on BOTH
multi-window burn rates → the autopilot **tightens** — one level per
breached evaluation, each level raising the admission controller's shed
bias (the shard sheds low bands earlier) and scaling over-quota
tenants' announce-rate caps down (``TenantAccounting.set_cap_factor``).
Recovery **relaxes** with hysteresis: only after ``relax_after``
consecutive healthy evaluations does the level step back down, so a
flapping SLO cannot oscillate the shed floor.

Replay-equals-live (the §23 discipline, taken one step further): the
live decision path is *journal-driven* — every evaluation ingests a
metric-journal snapshot (``MetricJournal.last_snapshot``) through the
same ``SLOEngine.ingest_snapshot``/``evaluate`` pair replay uses, and
the level transition is a pure function of the resulting breach-verdict
sequence.  ``SLOAutopilot.replay`` therefore reproduces the live
decision sequence EXACTLY from the journal alone (drift 0), which is
the drill's acceptance bar — and what makes a post-incident "why did
the autopilot shed?" answerable from artifacts.

Every level change closes one ``scheduler/qos.autopilot`` span
(DF016-inventoried) carrying from/to levels and the triggering verdict.

Port of ``dragonfly2_tpu/qos/autopilot.py``, verbatim.  ``admission``
is any object with ``set_shed_bias``: the scheduler binary
(``cli/scheduler.serve``) hands it the shard guard's admission
controller, as the reference's does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.metrics import Registry
from ..utils.slo import SLOEngine
from ..utils.tracing import default_tracer
from . import metrics


class SLOAutopilot:
    """See module doc.  ``admission`` is a sharding.AdmissionController
    (duck-typed on ``set_shed_bias``), ``accounting`` a
    ``TenantAccounting``; either may be None (decide-only mode — the
    replay path runs this way)."""

    def __init__(
        self,
        slos: Sequence[Any],
        *,
        admission=None,
        accounting=None,
        max_level: int = 4,
        shed_bias_step: float = 0.2,
        cap_backoff: float = 0.5,
        relax_after: int = 3,
    ) -> None:
        # Snapshot-fed engine: the registry is never sampled live, so
        # live and replay run byte-identical arithmetic.
        self.engine = SLOEngine(slos, registry=Registry())
        self.admission = admission
        self.accounting = accounting
        self.max_level = max_level
        self.shed_bias_step = shed_bias_step
        self.cap_backoff = cap_backoff
        self.relax_after = relax_after
        self._level = 0
        self._ok_streak = 0
        # (ts, breached, level) per evaluation — the drill's live
        # decision sequence.
        self.decisions: List[Tuple[float, bool, int]] = []

    @property
    def level(self) -> int:
        return self._level

    # -- the journal-driven evaluation ---------------------------------------

    def ingest(self, snapshot: Dict[str, Any]) -> int:
        """Feed one metric-journal snapshot (live: the frame the journal
        just wrote; replay: a frame read back off disk) and re-decide.
        Returns the level in force after this evaluation."""
        self.engine.ingest_snapshot(snapshot)
        t = float(snapshot.get("ts", 0.0))
        state = self.engine.evaluate(t)
        breached = any(
            state[s.name]["breached"] for s in self.engine.slos
        )
        return self._step(breached, t)

    def _step(self, breached: bool, t: float) -> int:
        prev = self._level
        if breached:
            self._ok_streak = 0
            level = min(prev + 1, self.max_level)
        else:
            self._ok_streak += 1
            if prev > 0 and self._ok_streak >= self.relax_after:
                level = prev - 1
                self._ok_streak = 0
            else:
                level = prev
        self._level = level
        self.decisions.append((t, breached, level))
        if level != prev:
            # The adjustment span: the flight recorder's answer to "why
            # did the shed floor move at 12:03".  Never opened on the
            # steady state — a healthy fleet records zero of these.
            with default_tracer.span(
                "scheduler/qos.autopilot",
                from_level=prev, to_level=level, breached=breached,
            ):
                self._apply(level)
            metrics.AUTOPILOT_ADJUSTMENTS_TOTAL.inc(
                direction="tighten" if level > prev else "relax"
            )
        metrics.AUTOPILOT_LEVEL.set(float(level))
        return level

    def _apply(self, level: int) -> None:
        if self.admission is not None:
            self.admission.set_shed_bias(level * self.shed_bias_step)
        if self.accounting is not None:
            self.accounting.set_cap_factor(self.cap_backoff ** level)

    # -- journal replay (the drill's parity bar) -----------------------------

    @classmethod
    def replay(
        cls,
        snapshots: Sequence[Dict[str, Any]],
        slos: Sequence[Any],
        **kwargs: Any,
    ) -> "SLOAutopilot":
        """Re-run the decision sequence from replayed journal snapshots
        (``utils.metric_journal.replay_metric_journal`` output, one
        process stream in seq order).  The returned pilot's
        ``decisions`` must equal the live pilot's exactly — same
        snapshots, same engine arithmetic, same pure transition
        function."""
        pilot = cls(slos, **kwargs)
        ordered = sorted(
            snapshots, key=lambda s: (s.get("seq", 0), s.get("ts", 0.0))
        )
        for snap in ordered:
            pilot.ingest(snap)
        return pilot

    def levels(self) -> List[int]:
        return [level for _t, _b, level in self.decisions]

    def close(self) -> None:
        self.engine.close()
