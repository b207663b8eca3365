"""The gRPC server interceptor over ``ratelimit.TokenBucket``.

Port of ``RateLimitInterceptor`` from ``dragonfly2_tpu/rpc/ratelimit.py``,
verbatim.  It lives in a module of its own because it subclasses
``grpc.ServerInterceptor``: ``ratelimit`` re-exports it lazily, so the
HTTP servers that import ``ratelimit`` never import ``grpc``.
"""

from __future__ import annotations

import grpc

from .ratelimit import TokenBucket


class RateLimitInterceptor(grpc.ServerInterceptor):
    """Rejects calls with RESOURCE_EXHAUSTED once the bucket drains
    (interceptor.go limit() → resource-exhausted conversion)."""

    def __init__(self, bucket: TokenBucket) -> None:
        self.bucket = bucket

    def intercept_service(self, continuation, handler_call_details):
        if self.bucket.take():
            return continuation(handler_call_details)
        from .metrics import RATE_LIMITED_TOTAL

        RATE_LIMITED_TOTAL.inc(transport="grpc")

        def reject(request, context):
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED, "rate limit exceeded"
            )

        return grpc.unary_unary_rpc_method_handler(reject)
