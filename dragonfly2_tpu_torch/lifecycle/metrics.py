"""Lifecycle-plane metrics (DF017 REQUIRED_METRICS).

Port of ``dragonfly2_tpu/lifecycle/metrics.py``, verbatim.

The zero-human loop's scrape surface: epoch cadence, promotion/rollback
outcomes, and the records-in → candidate-registered epoch latency.  The
``name`` label is the registry model name (``base`` or ``base@region``) —
bounded by configuration, never a per-entity identifier.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

LIFECYCLE_EPOCHS_TOTAL = _reg.counter(
    "lifecycle_epochs_total",
    "training epochs cut by the lifecycle daemon (exported + registered)",
    ["name"],
)

LIFECYCLE_PROMOTIONS_TOTAL = _reg.counter(
    "lifecycle_promotions_total",
    "candidates the zero-human loop promoted to ACTIVE",
    ["name"],
)

LIFECYCLE_ROLLBACKS_TOTAL = _reg.counter(
    "lifecycle_rollbacks_total",
    "candidates auto-rolled back or retired by the guardrails/arbitration",
    ["name"],
)

LIFECYCLE_DROPPED_RECORDS_TOTAL = _reg.counter(
    "lifecycle_dropped_records_total",
    "records dropped at the trainer-queue boundary (never trained on, "
    "never counted toward the epoch cadence)",
    ["name"],
)

LIFECYCLE_EPOCH_SECONDS = _reg.sketch(
    "lifecycle_epoch_seconds",
    "one epoch's train → export → register → rollout-begin latency",
)
