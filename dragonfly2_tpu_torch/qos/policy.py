"""Tenant identity + per-tenant QoS configuration (DESIGN.md §26).

The reference manager keys traffic to users/PATs/clusters; here the
same identities map onto a **tenant id**: authenticated callers derive
``t-<user id>`` (``derive_tenant``), unauthenticated clusters declare
one in their daemon config (``DaemonConfig.tenant``), and everything
else rides as the ``default`` tenant.

A ``TenantQoS`` row declares what a tenant is entitled to:

- ``priority``            — the default priority class stamped on the
                            tenant's tasks/announces when the workload
                            does not say (preheat jobs override DOWN to
                            LEVEL6 regardless);
- ``weight``              — the weighted-fair share (traffic shaper
                            tenant split, scorer-batcher DRR quantum,
                            admission over-quota test);
- ``upload_rate_bytes_s`` — daemon upload-path bandwidth cap (0 = none);
- ``announce_qps``        — announce/register rate cap at the scheduler
                            admission gate (0 = none);
- ``tenant_class``        — the BOUNDED label ("gold".."background")
                            metrics carry instead of raw tenant ids
                            (DF017: a raw tenant id label is a
                            cardinality explosion on a real fleet).

``QoSPolicy`` is the immutable collection the manager publishes as the
``tenant_qos`` blob of the cluster dynconfig; holders swap whole policy
references atomically (the §18 snapshot discipline), never mutate one.

Port of ``dragonfly2_tpu/qos/policy.py``, verbatim.
"""

from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Any, Dict, Mapping, Optional

DEFAULT_TENANT = "default"

# Bounded tenant classes — the ONLY tenant-shaped metric label allowed
# (DF017 FORBIDDEN_LABELS bans raw tenant ids by name).
TENANT_CLASSES = ("gold", "silver", "bronze", "background")

_TENANT_RE = re.compile(r"[^A-Za-z0-9._-]+")


def derive_tenant(subject: str) -> str:
    """Tenant id from an authenticated subject (user id of a session
    token or PAT owner): ``t-<subject>``, sanitized to the same boring
    charset CRUD row ids use.  Deterministic — every service derives the
    SAME tenant for one identity without coordination."""
    clean = _TENANT_RE.sub("-", subject or "").strip("-")
    return f"t-{clean}" if clean else DEFAULT_TENANT


@dataclass(frozen=True)
class TenantQoS:
    """One tenant's declared QoS entitlement (see module doc)."""

    tenant: str
    tenant_class: str = "silver"
    priority: int = 0
    weight: float = 1.0
    upload_rate_bytes_s: float = 0.0
    announce_qps: float = 0.0
    announce_burst: int = 0

    def validate(self) -> None:
        if not self.tenant:
            raise ValueError("tenant_qos entry needs a tenant id")
        if self.tenant_class not in TENANT_CLASSES:
            raise ValueError(
                f"tenant {self.tenant!r}: tenant_class "
                f"{self.tenant_class!r} not in {TENANT_CLASSES}"
            )
        if not (0 <= int(self.priority) <= 6):
            raise ValueError(
                f"tenant {self.tenant!r}: priority must be in [0, 6]"
            )
        if self.weight <= 0:
            raise ValueError(f"tenant {self.tenant!r}: weight must be > 0")
        if self.upload_rate_bytes_s < 0 or self.announce_qps < 0:
            raise ValueError(
                f"tenant {self.tenant!r}: rate caps must be >= 0 (0 = none)"
            )
        if self.announce_burst < 0:
            raise ValueError(
                f"tenant {self.tenant!r}: announce_burst must be >= 0"
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TenantQoS":
        unknown = set(d) - {f for f in cls.__dataclass_fields__}
        if unknown:
            raise ValueError(f"tenant_qos: unknown keys {sorted(unknown)}")
        row = cls(**dict(d))
        row.validate()
        return row

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def parse_tenant_qos(raw: Any) -> Dict[str, TenantQoS]:
    """``tenant_qos`` blob → validated rows, keyed by tenant id.  The
    blob shape is ``{tenant_id: {weight: .., announce_qps: ..}, ...}``
    (the tenant key wins over any inline ``tenant`` field).  Raises
    ValueError on malformed entries — surfaced by the manager's
    cluster-blob write validation and config validate()."""
    if raw is None:
        return {}
    if not isinstance(raw, Mapping):
        raise ValueError(
            f"tenant_qos must be an object, got {type(raw).__name__}"
        )
    out: Dict[str, TenantQoS] = {}
    for tenant, entry in raw.items():
        if not isinstance(entry, Mapping):
            raise ValueError(f"tenant_qos[{tenant!r}] must be an object")
        d = dict(entry)
        d["tenant"] = str(tenant)
        out[str(tenant)] = TenantQoS.from_dict(d)
    return out


class QoSPolicy:
    """Immutable per-tenant QoS table with a default row for tenants no
    entry names.  Built once per dynconfig payload; every enforcement
    point reads ONE reference atomically."""

    def __init__(
        self,
        tenants: Optional[Mapping[str, TenantQoS]] = None,
        *,
        default: Optional[TenantQoS] = None,
    ) -> None:
        self._tenants: Dict[str, TenantQoS] = dict(tenants or {})
        for row in self._tenants.values():
            row.validate()
        self._default = default or self._tenants.get(DEFAULT_TENANT) or (
            TenantQoS(tenant=DEFAULT_TENANT)
        )
        self._default.validate()

    # -- lookups -------------------------------------------------------------

    def for_tenant(self, tenant: str) -> TenantQoS:
        row = self._tenants.get(tenant or DEFAULT_TENANT)
        if row is not None:
            return row
        d = self._default
        if d.tenant == (tenant or DEFAULT_TENANT):
            return d
        # Unknown tenants inherit the default entitlement under their
        # own id (accounting stays per-tenant even without a row).
        return TenantQoS(
            tenant=tenant or DEFAULT_TENANT,
            tenant_class=d.tenant_class,
            priority=d.priority,
            weight=d.weight,
            upload_rate_bytes_s=d.upload_rate_bytes_s,
            announce_qps=d.announce_qps,
            announce_burst=d.announce_burst,
        )

    def weight_of(self, tenant: str) -> float:
        return float(self.for_tenant(tenant).weight)

    def class_of(self, tenant: str) -> str:
        """The bounded metric label for a tenant (never the raw id)."""
        return self.for_tenant(tenant).tenant_class

    def tenants(self) -> Dict[str, TenantQoS]:
        return dict(self._tenants)

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._tenants

    # -- wire form (cluster dynconfig blob) ----------------------------------

    def to_payload(self) -> Dict[str, Dict[str, Any]]:
        return {t: row.to_dict() for t, row in sorted(self._tenants.items())}

    @classmethod
    def from_payload(cls, payload: Any) -> "QoSPolicy":
        return cls(parse_tenant_qos(payload))
