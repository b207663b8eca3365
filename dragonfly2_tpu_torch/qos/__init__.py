"""Multi-tenant QoS plane (DESIGN.md §26).

"Millions of users" means contending tenants, not one big swarm.  This
package is the policy + enforcement glue the four services share:

- ``policy``     — tenant identity derivation and the per-tenant QoS
                   config record (priority class, weight, upload
                   bandwidth cap, announce-rate cap) the manager
                   publishes with the cluster dynconfig.
- ``accounting`` — ONE accounting object consolidating the announce
                   path's per-request costs: windowed per-tenant usage,
                   announce-rate token buckets, shed bookkeeping, and
                   the over-quota signal overload shedding keys on.
- ``autopilot``  — the §23 feedback loop: declared-SLO burn verdicts
                   tighten the shard's shed floor and over-quota
                   tenants' announce caps, and relax on recovery; every
                   decision is a stateless function of the snapshot
                   history, so journal replay reproduces live decisions
                   exactly.

Enforcement itself lives at the chokepoints that already existed: the
daemon upload gate (``daemon/upload.py``), the hierarchical traffic
shaper (``daemon/traffic_shaper.py``), the scorer micro-batcher's
deficit-round-robin lanes (``scheduler/microbatch.py``), and the
admission controller (``scheduler/sharding.py``).

Port of ``dragonfly2_tpu/qos/``, with the logic verbatim.  Every
chokepoint named above reads the policy in this package too.
"""

from .accounting import TenantAccounting  # noqa: F401
from .autopilot import SLOAutopilot  # noqa: F401
from .policy import (  # noqa: F401
    DEFAULT_TENANT,
    TENANT_CLASSES,
    QoSPolicy,
    TenantQoS,
    derive_tenant,
    parse_tenant_qos,
)
