"""Wire-layer metrics (reference: grpc_prometheus interceptors on every
gRPC server + the rate-limit interceptor, pkg/rpc/interceptor.go).

Port of the part of ``dragonfly2_tpu/rpc/metrics.py`` the HTTP half
reads: the rate limiter's rejections, the manager endpoints' failovers
and the circuit breakers' state.  The gRPC, sync-peers and manager-HA
series come with the modules that write them.
"""

from __future__ import annotations

from ..utils.metrics import default_registry as _reg

RATE_LIMITED_TOTAL = _reg.counter(
    "rpc_rate_limited_total", "Requests rejected by the rate limiter",
    ["transport"],
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
