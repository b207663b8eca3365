"""Scheduler metrics (reference: scheduler/metrics/metrics.go:44-180 —
~40 prometheus series: announce/register/download/piece totals+failures,
traffic by type, concurrency gauges).

Defined on the process-default registry; the service layer incs them at
the same seams the reference's handlers do. `expose_text()` is served by
the metrics port.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

REGISTER_PEER_TOTAL = _reg.counter(
    "scheduler_register_peer_total", "RegisterPeer requests", ["result"]
)
SCHEDULE_TOTAL = _reg.counter(
    "scheduler_schedule_total", "Scheduling outcomes", ["outcome"]
)
SCHEDULE_RETRIES = _reg.histogram(
    "scheduler_schedule_retries", "Retries per scheduling round",
    buckets=(0, 1, 2, 3, 4, 5),
)
PIECE_RESULT_TOTAL = _reg.counter(
    "scheduler_piece_result_total", "Reported piece results", ["result"]
)
PEER_RESULT_TOTAL = _reg.counter(
    "scheduler_peer_result_total", "Reported peer results", ["result"]
)
DOWNLOAD_RECORDS_TOTAL = _reg.counter(
    "scheduler_download_records_total", "Training records written"
)
PROBE_SYNC_TOTAL = _reg.counter(
    "scheduler_probe_sync_total", "SyncProbes rounds", ["phase"]
)
HOSTS_GAUGE = _reg.gauge("scheduler_hosts", "Registered hosts")
PEERS_GAUGE = _reg.gauge("scheduler_peers", "Live peers")
TASKS_GAUGE = _reg.gauge("scheduler_tasks", "Live tasks")

# -- serving engine (DESIGN.md §14: vectorized evaluate path) ----------------
EVAL_SECONDS = _reg.histogram(
    "scheduler_eval_seconds", "evaluate_parents latency", ["algorithm"],
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25),
)
EVAL_CACHE_TOTAL = _reg.counter(
    "scheduler_eval_cache_hits_total",
    "Host-feature cache lookups by outcome", ["result"],
)
EVAL_BATCH_SIZE = _reg.histogram(
    "scheduler_eval_batch_size",
    "Requests coalesced per scorer micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
EVAL_BATCH_FALLBACK_TOTAL = _reg.counter(
    "scheduler_eval_batch_fallback_total",
    "Coalesced scorer batches degraded to per-request scoring",
)
EVAL_RULE_DEGRADE_TOTAL = _reg.counter(
    "scheduler_eval_rule_degrade_total",
    "ML announces ranked by the rule fallback after a scorer-path failure",
)

# -- fleet telemetry plane (DESIGN.md §23: mergeable percentile sketches) ----
# Sketches carry the tail losslessly across processes (fixed-bucket
# histograms cannot): journaled crash-safe (utils/metric_journal.py) and
# merged fleet-wide by tools/fleet_assemble.py.
ANNOUNCE_SECONDS = _reg.sketch(
    "scheduler_announce_seconds",
    "announce_host handling latency (store/refresh + column write)",
)
EVAL_FLUSH_SECONDS = _reg.sketch(
    "scheduler_eval_flush_seconds",
    "Coalesced scorer flush latency per dispatched group "
    "(ScorerBatcher, DESIGN.md §14)",
)

# -- rollout plane (DESIGN.md §15: shadow scoring + canary serving) ----------
SHADOW_ANNOUNCES_TOTAL = _reg.counter(
    "scheduler_shadow_announces_total",
    "Shadow-scoring outcomes per announce", ["result"],  # scored|sampled_out|dropped|error
)
CANARY_ANNOUNCES_TOTAL = _reg.counter(
    "scheduler_canary_announces_total",
    "Announces routed per canary arm", ["arm"],  # candidate|active
)
ROLLOUT_SERVING_STATE = _reg.gauge(
    "scheduler_rollout_state",
    "Local rollout serving state per model name: 0 active-only, "
    "2 shadow, 3 canary (codes match manager rollout_state)", ["name"],
)
