"""Wire-layer metrics (reference: grpc_prometheus interceptors on every
gRPC server + the rate-limit interceptor, pkg/rpc/interceptor.go).

Port of the part of ``dragonfly2_tpu/rpc/metrics.py`` the port writes:
the gRPC servers' requests, the rate limiter's rejections, the manager
endpoints' failovers, the circuit breakers' state, the daemon control
API's downloads, the manager's sync-peers rounds and the manager-HA plane
(role, replication lag, failovers and the replicated commit's wall), with
the reference's names, help and labels.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

GRPC_REQUESTS_TOTAL = _reg.counter(
    "rpc_grpc_requests_total", "gRPC requests handled",
    ["service", "method", "code"],
)
RATE_LIMITED_TOTAL = _reg.counter(
    "rpc_rate_limited_total", "Requests rejected by the rate limiter",
    ["transport"],
)
SYNC_PEERS_ROUNDS_TOTAL = _reg.counter(
    "manager_sync_peers_rounds_total", "sync_peers rounds completed"
)
SYNC_PEERS_ACTIVE = _reg.gauge(
    "manager_sync_peers_active_peers", "Active peers in the last merge"
)
# -- manager HA plane (manager/replication.py, DESIGN.md §20) ---------------
MANAGER_ROLE = _reg.gauge(
    "manager_role",
    "1 for this process's current replication role, 0 otherwise",
    ["role"],
)
REPLICATION_LAG = _reg.gauge(
    "manager_replication_lag_seconds",
    "Seconds since this follower last matched the leader's log frontier",
)
MANAGER_FAILOVERS_TOTAL = _reg.counter(
    "manager_failovers_total",
    "Standby-to-leader promotions performed by this process",
    ["node"],
)
MANAGER_ENDPOINT_FAILOVERS_TOTAL = _reg.counter(
    "manager_endpoint_failovers_total",
    "Client-side manager endpoint rotations after a failed call",
    ["client"],
)
CIRCUIT_BREAKER_STATE = _reg.gauge(
    "rpc_circuit_breaker_state",
    "Per-target breaker state: 0 closed, 1 half_open, 2 open",
    ["target"],
)
DAEMON_CONTROL_DOWNLOADS = _reg.counter(
    "daemon_control_downloads_total", "Downloads via the control API",
    ["result"],
)
# Fleet telemetry sketch (DESIGN.md §23): write-ahead append + data
# commit wall per replicated op — the control plane's commit-lag tail,
# journaled crash-safe next to the data-plane sketches.
REPLICATION_COMMIT_SECONDS = _reg.sketch(
    "manager_replication_commit_seconds",
    "Replicated commit wall (WAL append + data commit, per op)",
)
