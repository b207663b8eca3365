"""QoS-plane metrics (DESIGN.md §26).

Tenant-shaped series carry the BOUNDED ``tenant_class`` label
("gold".."background"), never raw tenant ids — one series per tenant is
a cardinality explosion on a million-user fleet, and DF017 bans the raw
label names outright.

Port of ``dragonfly2_tpu/qos/metrics.py``, verbatim, on this package's
metrics registry.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

QOS_SHED_TOTAL = _reg.counter(
    "scheduler_qos_shed_total",
    "Requests shed by tenant-aware admission control, by tenant class "
    "and priority band",
    ["tenant_class", "priority"],
)
QOS_RATE_CAPPED_TOTAL = _reg.counter(
    "scheduler_qos_rate_capped_total",
    "Requests refused by a tenant's announce-rate token bucket",
    ["tenant_class"],
)
AUTOPILOT_LEVEL = _reg.gauge(
    "scheduler_qos_autopilot_level",
    "Current SLO-autopilot tightening level (0 = declared policy; each "
    "level raises the shed bias and tightens over-quota announce caps)",
)
AUTOPILOT_ADJUSTMENTS_TOTAL = _reg.counter(
    "scheduler_qos_autopilot_adjustments_total",
    "Autopilot level transitions, by direction", ["direction"],
)
