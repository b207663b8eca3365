"""SLO evaluation: declared objectives + multi-window burn-rate alerts
(DESIGN.md §23).

An SLO declares what fraction of events must be *good* over a window —
``99% of piece fetches complete within 500 ms`` (latency objective over
a Sketch metric) or ``99.9% of flushes succeed`` (availability objective
over a good/total counter pair).  The engine tracks the cumulative
(good, total) signal and evaluates the **burn rate**: the observed bad
fraction divided by the error budget ``1 − target``.  Burn rate 1.0
means the budget is being consumed exactly at the sustainable pace;
burn rate 20 means a 30-day budget dies in ~36 hours.

Alerts follow the multi-window discipline (SRE workbook ch.5): breached
only while BOTH the fast window (default 5 m — catches the spike,
clears quickly on recovery) and the slow window (default 1 h — immune
to blips) burn above ``burn_threshold``.  The verdict is stateless in
the sample history, so replaying a metric journal through
``ingest_snapshot`` reconstructs exactly the state the live engine
served on ``/debug/slo`` — the telemetry drill's acceptance bar
(sim/telemetry.py).

Machine-readable output for the future SLO autopilot (ROADMAP):
``slo_burn_rate{slo}`` / ``slo_breached{slo}`` gauges on the default
registry, and the ``/debug/slo`` JSON on every DiagnosticsServer and
the manager REST surface.

Port of ``dragonfly2_tpu/utils/slo.py``, with the logic verbatim over
this package's own metrics registry and sketches.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import (
    Registry,
    Sketch,
    default_registry as _reg,
    merge_sketch_states,
    sketch_state_count_below,
)
from .tracing import _raw_lock

SLO_BURN_RATE = _reg.gauge(
    "slo_burn_rate",
    "Fast-window burn rate per SLO (bad fraction / error budget; "
    "1.0 = consuming budget exactly at the sustainable pace)",
    ["slo"],
)
SLO_BREACHED = _reg.gauge(
    "slo_breached",
    "1 while an SLO's fast AND slow windows both burn above its "
    "threshold (multi-window alert), else 0",
    ["slo"],
)

OBJECTIVES = ("latency", "availability")


@dataclass
class SLO:
    """One declared objective (config ``telemetry.slos`` entry)."""

    name: str
    objective: str                # "latency" | "availability"
    target: float                 # required good fraction, in (0, 1)
    metric: str = ""              # latency: Sketch metric name
    threshold_ms: float = 0.0     # latency: good iff ≤ threshold
    good_metric: str = ""         # availability: good-event counter
    total_metric: str = ""        # availability: total-event counter
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    burn_threshold: float = 2.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLO":
        unknown = set(d) - {f for f in cls.__dataclass_fields__}
        if unknown:
            raise ValueError(f"slo: unknown keys {sorted(unknown)}")
        slo = cls(**d)
        slo.validate()
        return slo

    def validate(self) -> None:
        if not self.name:
            raise ValueError("slo needs a name")
        if self.objective not in OBJECTIVES:
            raise ValueError(
                f"slo {self.name!r}: objective {self.objective!r} "
                f"not in {OBJECTIVES}"
            )
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"slo {self.name!r}: target must be in (0, 1) — an SLO "
                "of exactly 1.0 has no error budget to burn"
            )
        if self.objective == "latency":
            if not self.metric or self.threshold_ms <= 0:
                raise ValueError(
                    f"slo {self.name!r}: latency objective needs metric "
                    "and threshold_ms > 0"
                )
        else:
            if not self.good_metric or not self.total_metric:
                raise ValueError(
                    f"slo {self.name!r}: availability objective needs "
                    "good_metric and total_metric"
                )
        if not (0 < self.fast_window_s < self.slow_window_s):
            raise ValueError(
                f"slo {self.name!r}: need 0 < fast_window_s < slow_window_s"
            )
        if self.burn_threshold <= 0:
            raise ValueError(f"slo {self.name!r}: burn_threshold must be > 0")


def parse_slos(raw: Sequence[Any]) -> List[SLO]:
    """Config entries → validated SLO list (ValueError on bad entries —
    surfaced by config validate())."""
    out: List[SLO] = []
    for entry in raw:
        out.append(entry if isinstance(entry, SLO) else SLO.from_dict(entry))
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate slo names: {names}")
    return out


def _sum_counter_state(state: Optional[Dict[str, Any]]) -> float:
    if not state:
        return 0.0
    return float(sum(v for _key, v in state.get("series", [])))


def _merged_sketch_state(state: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not state or state.get("type") != "sketch":
        return None
    return merge_sketch_states([st for _key, st in state.get("series", [])])


class SLOEngine:
    """Samples the cumulative (good, total) signal per SLO — live from a
    Registry via ``tick()``, or from replayed journal snapshots via
    ``ingest_snapshot()`` — and evaluates multi-window burn rates over
    the sample history.  Both paths share the same ingest/evaluate code,
    which is what makes live state and journal-replay state provably
    identical."""

    def __init__(
        self,
        slos: Sequence[Any],
        *,
        registry: Optional[Registry] = None,
    ) -> None:
        self.slos = parse_slos(slos)
        self.registry = registry if registry is not None else _reg
        self._mu = _raw_lock()
        # Per-SLO (t, good, total) cumulative samples, oldest first.
        self._samples: Dict[str, deque] = {s.name: deque() for s in self.slos}
        self._last: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal extraction ---------------------------------------------------

    def _cumulative_live(self, slo: SLO) -> Tuple[float, float]:
        if slo.objective == "latency":
            m = self.registry.get(slo.metric)
            if not isinstance(m, Sketch):
                return 0.0, 0.0
            agg = m.aggregate_state()
            good = sketch_state_count_below(agg, slo.threshold_ms / 1e3)
            return good, float(agg["total"])
        good_m = self.registry.get(slo.good_metric)
        total_m = self.registry.get(slo.total_metric)
        good = _sum_counter_state(good_m.state()) if good_m is not None else 0.0
        total = _sum_counter_state(total_m.state()) if total_m is not None else 0.0
        return good, total

    @staticmethod
    def _cumulative_from_snapshot(
        slo: SLO, metrics: Dict[str, Any]
    ) -> Tuple[float, float]:
        if slo.objective == "latency":
            merged = _merged_sketch_state(metrics.get(slo.metric))
            if merged is None:
                return 0.0, 0.0
            good = sketch_state_count_below(merged, slo.threshold_ms / 1e3)
            return good, float(merged["total"])
        return (
            _sum_counter_state(metrics.get(slo.good_metric)),
            _sum_counter_state(metrics.get(slo.total_metric)),
        )

    # -- ingest + evaluate ---------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Sample the live registry and re-evaluate every SLO."""
        t = time.time() if now is None else now
        for slo in self.slos:
            good, total = self._cumulative_live(slo)
            self._ingest(slo, t, good, total)
        return self.evaluate(t)

    def ingest_snapshot(self, snapshot: Dict[str, Any]) -> None:
        """Feed one replayed journal snapshot (cumulative state at its
        ``ts``).  Feed snapshots of ONE process stream in ts order —
        fleet-level replay merges per-process streams first
        (tools/fleet_assemble.py)."""
        t = float(snapshot.get("ts", 0.0))
        metrics = snapshot.get("metrics", {})
        for slo in self.slos:
            good, total = self._cumulative_from_snapshot(slo, metrics)
            self._ingest(slo, t, good, total)

    def _ingest(self, slo: SLO, t: float, good: float, total: float) -> None:
        with self._mu:
            samples = self._samples[slo.name]
            samples.append((t, good, total))
            # Bound the history: one sample beyond the slow window is
            # enough to anchor the slow delta.
            horizon = t - slo.slow_window_s * 1.25
            while len(samples) > 2 and samples[1][0] <= horizon:
                samples.popleft()

    @staticmethod
    def _window_burn(
        samples: Sequence[Tuple[float, float, float]],
        t: float,
        window_s: float,
        budget: float,
    ) -> Tuple[float, float]:
        """(burn_rate, events_in_window) over [t−window, t].  Baseline =
        the newest sample at or before the window start (the oldest one
        during warm-up, so a fresh engine still answers)."""
        if not samples:
            return 0.0, 0.0
        start = t - window_s
        base = samples[0]
        for s in samples:
            if s[0] <= start:
                base = s
            else:
                break
        cur = samples[-1]
        d_total = cur[2] - base[2]
        if d_total <= 0:
            return 0.0, 0.0
        d_bad = (cur[2] - cur[1]) - (base[2] - base[1])
        bad_frac = min(max(d_bad / d_total, 0.0), 1.0)
        return bad_frac / budget, d_total

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Burn rates + breach verdicts from the current sample history;
        updates the ``slo_burn_rate``/``slo_breached`` gauges.

        ``evaluate`` is a declared replay root (DESIGN.md §27): its
        verdicts must be a pure function of the ingested samples and
        ``now``.  The live edge (``tick``) samples the wall clock
        OUTSIDE the replay path and passes it through the declared
        ``now`` injection seam; when ``now`` is omitted the engine
        anchors at the newest ingested sample instead of reading the
        ambient clock (DF018) — identical verdicts either way, since
        window ends are already clamped to the newest sample below."""
        if now is None:
            with self._mu:
                t = max(
                    (s[-1][0] for s in self._samples.values() if s),
                    default=0.0,
                )
        else:
            t = now
        out: Dict[str, Dict[str, Any]] = {}
        for slo in self.slos:
            with self._mu:
                samples = list(self._samples[slo.name])
            if samples:
                t_eval = max(t, samples[-1][0])
            else:
                t_eval = t
            budget = 1.0 - slo.target
            fast, fast_events = self._window_burn(
                samples, t_eval, slo.fast_window_s, budget
            )
            slow, slow_events = self._window_burn(
                samples, t_eval, slo.slow_window_s, budget
            )
            breached = (
                fast >= slo.burn_threshold and slow >= slo.burn_threshold
            )
            state = {
                "name": slo.name,
                "objective": slo.objective,
                "target": slo.target,
                "burn_threshold": slo.burn_threshold,
                "fast_window_s": slo.fast_window_s,
                "slow_window_s": slo.slow_window_s,
                "burn_rate_fast": round(fast, 6),
                "burn_rate_slow": round(slow, 6),
                "events_fast": fast_events,
                "events_slow": slow_events,
                "breached": breached,
                "samples": len(samples),
            }
            out[slo.name] = state
            with self._mu:
                self._last[slo.name] = state
            SLO_BURN_RATE.set(fast, slo=slo.name)
            SLO_BREACHED.set(1.0 if breached else 0.0, slo=slo.name)
        return out

    def state(self) -> Dict[str, Any]:
        """Last evaluated state (the ``/debug/slo`` payload) without
        re-sampling."""
        with self._mu:
            slos = [dict(self._last[s.name]) for s in self.slos
                    if s.name in self._last]
        return {"slos": slos}

    # -- background cadence --------------------------------------------------

    def start(self, interval_s: float = 5.0) -> "SLOEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, args=(max(0.05, interval_s),),
                name="slo-engine", daemon=True,
            )
            self._thread.start()
        return self

    def _run(self, interval_s: float) -> None:
        # Bounded waits (DF008 timeout sweep): stop event doubles as the
        # cadence clock.
        while not self._stop.wait(interval_s):
            self.tick()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            while t.is_alive():
                t.join(5.0)
                break


# ---------------------------------------------------------------------------
# Journal replay (fleet_assemble + the drill's live-vs-replay parity bar)
# ---------------------------------------------------------------------------


def replay_fleet(
    snapshots: Sequence[Dict[str, Any]], slos: Sequence[Any]
) -> SLOEngine:
    """Reconstruct an SLO engine from replayed journal snapshots —
    one process's stream or many processes' merged.

    Per-process snapshots are cumulative, so the fleet-cumulative signal
    at time t is the SUM over runs of each run's latest snapshot at or
    before t.  The returned engine's ``evaluate(t)`` then answers
    exactly what a live fleet-wide engine would have — the drill asserts
    this equals what ``/debug/slo`` served (sim/telemetry.py)."""
    engine = SLOEngine(slos, registry=Registry())
    by_run: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for snap in snapshots:
        key = (str(snap.get("service", "")), str(snap.get("run_id", "")))
        by_run.setdefault(key, []).append(snap)
    for stream in by_run.values():
        stream.sort(key=lambda s: (s.get("seq", 0), s.get("ts", 0.0)))
    times = sorted({float(s.get("ts", 0.0)) for s in snapshots})
    # Per-run stream pointers advance monotonically with t.
    pointers = {key: 0 for key in by_run}
    current: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for t in times:
        for key, stream in by_run.items():
            i = pointers[key]
            while i < len(stream) and float(stream[i].get("ts", 0.0)) <= t:
                current[key] = stream[i]
                i += 1
            pointers[key] = i
        for slo in engine.slos:
            good = total = 0.0
            for snap in current.values():
                g, n = engine._cumulative_from_snapshot(
                    slo, snap.get("metrics", {})
                )
                good += g
                total += n
            engine._ingest(slo, t, good, total)
    if times:
        engine.evaluate(times[-1])
    return engine


# ---------------------------------------------------------------------------
# Process-installed engine (the /debug/slo endpoints read it)
# ---------------------------------------------------------------------------

_ENGINE: Optional[SLOEngine] = None


def install_engine(engine: Optional[SLOEngine]) -> None:
    global _ENGINE
    _ENGINE = engine


def current_engine() -> Optional[SLOEngine]:
    return _ENGINE


def debug_state() -> Dict[str, Any]:
    """The ``/debug/slo`` payload: last evaluated per-SLO state, or an
    empty declaration when no engine is installed."""
    engine = _ENGINE
    if engine is None:
        return {"slos": [], "installed": False}
    out = engine.state()
    out["installed"] = True
    return out
