"""Per-tenant accounting: the ONE object behind the announce path's
per-request QoS costs (DESIGN.md §26).

Before this, per-request costs on the admission path were scattered
(in-flight counters on the controller, latency sketches, ad-hoc shed
counters).  ``TenantAccounting`` consolidates the tenant-scoped half:

- **windowed usage** — two-epoch-rotated per-tenant request counts (the
  §24 admission-sketch discipline): ``usage_share`` answers "what
  fraction of this shard's recent traffic is tenant X" without
  unbounded history;
- **announce-rate caps** — a per-tenant token bucket built from the
  published ``announce_qps``; the SLO autopilot's ``cap_factor``
  tightens the effective rate for OVER-QUOTA tenants only (a tenant
  inside its weighted share keeps its declared cap through an
  overload);
- **the over-quota signal** — ``usage_share / weight_share``; the
  admission controller scales its shed floor by this, so overload sheds
  the *noisy* tenant's lowest priority band first;
- **shed bookkeeping** — per-tenant shed counts for the drill verdicts
  and the bounded ``tenant_class`` metric label.

State is deliberately rebuildable: every field is a deterministic
function of the request stream since boot (plus the published policy),
so a SIGKILLed shard's replacement reconstructs equivalent accounting
by serving the same traffic — the chaos drill's bar.

Locking: ``_mu`` is a leaf lock; token buckets are taken OUTSIDE it.

Port of ``dragonfly2_tpu/qos/accounting.py``, verbatim, over this
package's ``rpc/ratelimit.TokenBucket``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..rpc.ratelimit import TokenBucket
from .policy import DEFAULT_TENANT, QoSPolicy


class _TenantRow:
    __slots__ = (
        "requests", "cur", "prev", "sheds", "capped", "bytes",
        "bucket", "bucket_rate",
    )

    def __init__(self) -> None:
        self.requests = 0        # cumulative since boot
        self.cur = 0             # current epoch window count
        self.prev = 0            # previous epoch window count
        self.sheds = 0
        self.capped = 0
        self.bytes = 0
        self.bucket: Optional[TokenBucket] = None
        self.bucket_rate = 0.0   # the qps the bucket was built for


class TenantAccounting:
    def __init__(
        self,
        policy: Optional[QoSPolicy] = None,
        *,
        window_s: float = 5.0,
        over_quota_slack: float = 1.25,
        now: Optional[float] = None,
    ) -> None:
        self._mu = threading.Lock()
        self._policy = policy or QoSPolicy()
        self.window_s = window_s
        # A tenant is "over quota" past usage_share > slack × weight_share
        # — the slack keeps bursty-but-entitled tenants out of the noisy
        # band (hysteresis against share jitter at low volumes).
        self.over_quota_slack = over_quota_slack
        self._rows: Dict[str, _TenantRow] = {}
        # ``now`` is a declared clock seam (DESIGN.md §27): the SIGKILL
        # rebuild drill re-anchors the window epoch at the scripted
        # replay clock so two rebuilds over the same stream agree.
        self._epoch_started = time.monotonic() if now is None else now
        # Autopilot output (qos/autopilot.py): scales the EFFECTIVE
        # announce rate of over-quota tenants; 1.0 = declared caps.
        self._cap_factor = 1.0

    # -- policy / autopilot inputs -------------------------------------------

    def set_policy(self, policy: QoSPolicy) -> None:
        with self._mu:
            self._policy = policy
            # Declared caps may have changed: rebuild buckets lazily by
            # invalidating the built-rate memo.
            for row in self._rows.values():
                row.bucket_rate = 0.0

    @property
    def policy(self) -> QoSPolicy:
        with self._mu:
            return self._policy

    def set_cap_factor(self, factor: float) -> None:
        """Autopilot tightening: over-quota tenants' announce caps scale
        by ``factor`` in (0, 1]; 1.0 restores declared rates."""
        with self._mu:
            self._cap_factor = max(0.05, min(1.0, float(factor)))
            for row in self._rows.values():
                row.bucket_rate = 0.0

    def cap_factor(self) -> float:
        with self._mu:
            return self._cap_factor

    # -- the per-request account ---------------------------------------------

    def _row_locked(self, tenant: str) -> _TenantRow:
        row = self._rows.get(tenant)
        if row is None:
            row = self._rows[tenant] = _TenantRow()
        return row

    def _rotate_locked(self, now: float) -> None:
        if now - self._epoch_started >= self.window_s:
            for row in self._rows.values():
                row.prev = row.cur
                row.cur = 0
            self._epoch_started = now

    def note(self, tenant: str, *, now: Optional[float] = None) -> bool:
        """Live edge: samples the monotonic clock OUTSIDE the replay
        path and delegates to ``note_at`` (the declared replay root —
        DESIGN.md §27)."""
        t = time.monotonic() if now is None else now
        return self.note_at(tenant, t)

    def note_at(self, tenant: str, now: float) -> bool:
        """Account one request for ``tenant`` at clock reading ``now``;
        False when the tenant's (possibly autopilot-tightened)
        announce-rate cap refuses it.  The request is counted either way
        — a capped flood still shows up as usage, which is what keeps
        the over-quota signal honest.

        A declared replay root: the verdict is a pure function of the
        request stream and its timestamps, so the SIGKILL rebuild drill
        can replay a scripted stream through the same door the live
        plane uses and land on identical state.
        """
        tenant = tenant or DEFAULT_TENANT
        with self._mu:
            self._rotate_locked(now)
            row = self._row_locked(tenant)
            row.requests += 1
            row.cur += 1
            qos = self._policy.for_tenant(tenant)
            declared = float(qos.announce_qps)
            qps = declared
            if qps > 0.0 and self._over_quota_locked(tenant) > self.over_quota_slack:
                qps *= self._cap_factor
            bucket = row.bucket
            if qps <= 0.0:
                row.bucket = None
                row.bucket_rate = 0.0
                return True
            if bucket is None or row.bucket_rate != qps:
                burst = qos.announce_burst or max(int(declared), 1)
                # A tightened rate tightens the burst headroom with it —
                # rebuilding at the declared burst would hand the capped
                # tenant a fresh declared-size token pile.
                burst = max(1, int(burst * (qps / declared)))
                bucket = row.bucket = TokenBucket(qps, burst)
                row.bucket_rate = qps
        if bucket.take_at(now):
            return True
        with self._mu:
            row.capped += 1
        return False

    def record_shed(self, tenant: str) -> None:
        with self._mu:
            self._row_locked(tenant or DEFAULT_TENANT).sheds += 1

    def record_bytes(self, tenant: str, nbytes: int) -> None:
        """Bandwidth accounting (the upload path's serve bytes)."""
        with self._mu:
            self._row_locked(tenant or DEFAULT_TENANT).bytes += int(nbytes)

    # -- the fairness signals ------------------------------------------------

    def _windowed_locked(self, tenant: str) -> int:
        row = self._rows.get(tenant)
        return (row.cur + row.prev) if row is not None else 0

    def _over_quota_locked(self, tenant: str) -> float:
        """usage_share / weight_share over the active window; 1.0 = at
        quota, >1 = noisy.  0 when the window is empty."""
        total = sum(r.cur + r.prev for r in self._rows.values())
        if total <= 0:
            return 0.0
        active = [t for t, r in self._rows.items() if r.cur + r.prev > 0]
        usage = self._windowed_locked(tenant) / total
        weights = {t: self._policy.weight_of(t) for t in active}
        wsum = sum(weights.values())
        if tenant not in weights or wsum <= 0:
            return 0.0
        return usage / (weights[tenant] / wsum)

    def over_quota(self, tenant: str) -> float:
        with self._mu:
            return self._over_quota_locked(tenant or DEFAULT_TENANT)

    def noise_factor(self, tenant: str) -> float:
        """Shed-floor multiplier in [1, 3]: 1 for tenants inside their
        weighted share, growing with how far past quota they run — the
        admission controller sheds a 3×-over-quota tenant's bands three
        times earlier than a within-quota one's."""
        with self._mu:
            ratio = self._over_quota_locked(tenant or DEFAULT_TENANT)
        if ratio <= self.over_quota_slack:
            return 1.0
        return min(3.0, ratio / self.over_quota_slack)

    def class_of(self, tenant: str) -> str:
        with self._mu:
            return self._policy.class_of(tenant or DEFAULT_TENANT)

    # -- observability / rebuild evidence ------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Deterministic per-tenant accounting state (the chaos drill's
        rebuild-equivalence evidence and the diagnostics payload)."""
        with self._mu:
            return {
                t: {
                    "requests": r.requests,
                    "windowed": r.cur + r.prev,
                    "sheds": r.sheds,
                    "capped": r.capped,
                    "bytes": r.bytes,
                    "over_quota": round(self._over_quota_locked(t), 4),
                    "tenant_class": self._policy.class_of(t),
                }
                for t, r in sorted(self._rows.items())
            }
