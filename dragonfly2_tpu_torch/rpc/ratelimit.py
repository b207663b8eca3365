"""Server-side rate limiting (reference: pkg/rpc/interceptor.go:69-128 —
a token-bucket RateLimiterInterceptor on every gRPC server).

Port of ``TokenBucket`` and ``maybe_bucket`` from
``dragonfly2_tpu/rpc/ratelimit.py``, verbatim: the HTTP wire servers
check the bucket (429).  The reference's ``RateLimitInterceptor`` plugs
the same bucket into gRPC servers and imports ``grpc`` at module level;
it comes with the gRPC half (ROADMAP queue 1 item 12c).
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class TokenBucket:
    """qps refill, burst capacity; non-blocking take."""

    def __init__(self, qps: float, burst: int) -> None:
        if qps <= 0 or burst <= 0:
            raise ValueError("qps and burst must be positive")
        self.qps = qps
        self.burst = float(burst)
        self._tokens = float(burst)
        # Anchored at the first take, not here: buckets are built on
        # replay paths (qos/accounting.py note_at) where ambient clock
        # reads are DF018-banned, and the first take starts from a full
        # burst either way.
        self._last: Optional[float] = None
        self._mu = threading.Lock()

    def take(self, n: float = 1.0) -> bool:
        """Live edge: samples the monotonic clock and delegates to
        ``take_at`` (the declared clock seam — DESIGN.md §27)."""
        return self.take_at(time.monotonic(), n)

    def take_at(self, now: float, n: float = 1.0) -> bool:
        with self._mu:
            if self._last is not None:
                # Scripted clocks may repeat a timestamp; never refill
                # backwards.
                elapsed = max(0.0, now - self._last)
                self._tokens = min(
                    self.burst, self._tokens + elapsed * self.qps
                )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


def maybe_bucket(qps: Optional[float], burst: Optional[int]) -> Optional[TokenBucket]:
    """Config helper: None/0 qps disables limiting."""
    if not qps:
        return None
    return TokenBucket(qps, burst or max(int(qps), 1))
