"""Rollout-plane metrics (manager controller side).

``rollout_state`` is the drill-visible series: one gauge per
(scheduler_id, name) carrying the numeric state code, so "the candidate
was rolled back" / "the canary froze at ACTIVE v3" is a scrape, not a
log grep.  Scheduler-side serving metrics (shadow/canary counters) live
in scheduler/metrics.py with the rest of the announce-path series.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

# Numeric codes for the rollout_state gauge.
STATE_CODES = {
    "none": 0,
    "candidate": 1,
    "shadow": 2,
    "canary": 3,
    "active": 4,
    "rolled_back": 5,
}

ROLLOUT_STATE = _reg.gauge(
    "rollout_state",
    "Rollout state per (scheduler, model name): 0 none, 1 candidate, "
    "2 shadow, 3 canary, 4 active, 5 rolled_back",
    ["scheduler_id", "name"],
)
ROLLOUT_TRANSITIONS_TOTAL = _reg.counter(
    "rollout_transitions_total", "Rollout state-machine transitions", ["to"]
)
ROLLOUT_REPORTS_TOTAL = _reg.counter(
    "rollout_reports_total", "Shadow/canary evaluation reports received",
    ["decision"],
)
