"""Per-task bandwidth allocation (reference: client/daemon/peer/traffic_shaper.go:36-133).

The reference's "sampling" shaper re-divides total bandwidth across active
tasks each second, proportional to observed need.  Same model: tasks
register, record consumed bytes, and ``allocate`` computes each task's
budget for the next window — used bandwidth attracts budget, idle tasks
shrink to a floor.

Multi-tenant hierarchy (DESIGN.md §26): with a ``QoSPolicy`` installed,
allocation is two-level — the total rate splits across TENANTS by
declared weight (clipped at each tenant's ``upload_rate_bytes_s`` cap,
the clipped remainder redistributed to uncapped tenants), then each
tenant's share splits across its tasks proportional to observed use,
exactly the single-level discipline.  With one tenant (or no policy)
the tenant split degenerates to the whole rate and behavior is
unchanged.

``add_task`` carves the min-share floor out of the EXISTING allocation
instead of resetting everyone to an equal split: a hot task's
history-weighted budget survives a cold task joining (it scales by
``(rate − floor) / rate`` until the next ``allocate`` window closes,
rather than collapsing to ``rate / n``).

Port of ``dragonfly2_tpu/daemon/traffic_shaper.py``, verbatim.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import threading

if TYPE_CHECKING:  # policy is duck-typed at runtime (no qos import cost)
    from ..qos.policy import QoSPolicy

DEFAULT_TENANT = "default"


class TrafficShaper:
    def __init__(self, total_rate: float, *, min_share: float = 0.05) -> None:
        """total_rate: bytes/sec across all tasks."""
        self.total_rate = total_rate
        self.min_share = min_share
        self._mu = threading.Lock()
        self._used: Dict[str, int] = {}
        self._budget: Dict[str, float] = {}
        self._tenant_of: Dict[str, str] = {}
        self._policy: "Optional[QoSPolicy]" = None
        # True once allocate() has run over OBSERVED use: only then are
        # budgets history-weighted and worth preserving across joins.
        self._history = False

    def set_policy(self, policy: "Optional[QoSPolicy]") -> None:
        """Install/clear the tenant QoS policy (weights + upload caps);
        takes effect at the next ``allocate`` window close."""
        with self._mu:
            self._policy = policy

    def add_task(self, task_id: str, tenant: str = DEFAULT_TENANT) -> None:
        with self._mu:
            if task_id in self._used:
                self._tenant_of[task_id] = tenant or DEFAULT_TENANT
                return
            self._used[task_id] = 0
            self._tenant_of[task_id] = tenant or DEFAULT_TENANT
            n = len(self._used)
            floor = min(self.total_rate * self.min_share, self.total_rate / n)
            existing_total = sum(
                b for t, b in self._budget.items() if t in self._used
            )
            if not self._history or existing_total <= 0.0:
                # No observed-use allocation yet: an equal split is all
                # the information there is (the pre-history behavior).
                for t in self._used:
                    self._budget[t] = self.total_rate / n
                return
            # Carve the joiner's floor out proportionally: every
            # existing budget scales by (rate − floor)/rate, so the
            # history-weighted proportions ``allocate`` computed survive
            # the join instead of resetting to an equal split.
            scale = max(0.0, (self.total_rate - floor)) / self.total_rate
            for t in self._used:
                if t != task_id:
                    self._budget[t] = self._budget.get(
                        t, self.total_rate / n
                    ) * scale
            self._budget[task_id] = floor

    def remove_task(self, task_id: str) -> None:
        with self._mu:
            self._used.pop(task_id, None)
            self._budget.pop(task_id, None)
            self._tenant_of.pop(task_id, None)

    def record(self, task_id: str, nbytes: int) -> None:
        with self._mu:
            if task_id in self._used:
                self._used[task_id] += nbytes

    def budget(self, task_id: str) -> float:
        with self._mu:
            return self._budget.get(task_id, 0.0)

    # -- window close --------------------------------------------------------

    def _tenant_rates_locked(self) -> Dict[str, float]:
        """Per-tenant rate split for the active tenant set: weight-
        proportional, clipped at each tenant's declared upload cap, the
        clipped surplus redistributed across UNCAPPED tenants by weight
        (one redistribution round; a fully-capped fleet leaves the
        surplus unallocated — caps are caps)."""
        tenants = sorted({self._tenant_of[t] for t in self._used})
        policy = self._policy
        if policy is None or len(tenants) <= 1:
            return {t: self.total_rate for t in tenants} or {}
        weights = {t: max(policy.weight_of(t), 1e-9) for t in tenants}
        wsum = sum(weights.values())
        caps = {
            t: policy.for_tenant(t).upload_rate_bytes_s or float("inf")
            for t in tenants
        }
        shares = {t: self.total_rate * weights[t] / wsum for t in tenants}
        rates = {t: min(shares[t], caps[t]) for t in tenants}
        surplus = self.total_rate - sum(rates.values())
        open_w = sum(weights[t] for t in tenants if rates[t] < caps[t])
        if surplus > 1e-9 and open_w > 0:
            for t in tenants:
                if rates[t] < caps[t]:
                    rates[t] = min(
                        caps[t], rates[t] + surplus * weights[t] / open_w
                    )
        return rates

    def allocate(self) -> Dict[str, float]:
        """Close the sampling window: tenant split by weight (see
        ``_tenant_rates_locked``), then use-proportional task budgets
        inside each tenant's share."""
        with self._mu:
            if not self._used:
                return {}
            if any(self._used.values()):
                self._history = True
            rates = self._tenant_rates_locked()
            by_tenant: Dict[str, list] = {}
            for t in self._used:
                by_tenant.setdefault(self._tenant_of[t], []).append(t)
            for tenant, tasks in by_tenant.items():
                rate = rates.get(tenant, self.total_rate)
                n = len(tasks)
                total_used = sum(self._used[t] for t in tasks)
                # Clamp the floor so n·floor never exceeds the tenant
                # rate — with many tasks an unclamped floor turns
                # `distributable` negative and inverts the allocation
                # (busiest task gets least).
                floor = min(rate * self.min_share, rate / n)
                if total_used == 0:
                    for t in tasks:
                        self._budget[t] = rate / n
                else:
                    distributable = rate - floor * n
                    for t in tasks:
                        self._budget[t] = floor + distributable * (
                            self._used[t] / total_used
                        )
            for t in self._used:
                self._used[t] = 0
            return dict(self._budget)
