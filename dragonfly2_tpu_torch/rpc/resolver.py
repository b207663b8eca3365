"""Multi-endpoint manager resolver (reference: pkg/resolver — gRPC
resolvers that watch dynconfig for the live backend lists and feed the
balancers, resolver/scheduler_resolver.go).

``ManagerEndpoints`` is the manager-HA half: ONE sticky ordered list of
manager replica URLs shared by every manager-facing client in a process
(cluster keepalive, dynconfig polls, registry/rollout fetches, the job
queue, topology sync).  ``call`` tries the current endpoint and fails
over on connection errors and on 503 (a standby refusing writes), so a
leader bounce moves the whole process to the survivor mid-flight — and
because the list is shared, the FIRST client to fail over moves
everyone.

Port of ``dragonfly2_tpu/rpc/resolver.py``'s ``ManagerEndpoints``,
verbatim.  ``SchedulerResolver`` (the daemon's dynconfig-fed scheduler
pick) and ``ShardRouter`` (routing over the shard guard's ring) come
with the peer daemon and the shard guard, ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import urllib.error
from typing import Callable, List, Optional, Sequence, TypeVar, Union

from .balancer import StickyFailover

T = TypeVar("T")


class ManagerEndpoints:
    """Sticky multi-endpoint manager address book (see module doc).

    Accepts a comma-separated spec (``"http://a:80,http://b:80"``), a
    sequence of URLs, or another ``ManagerEndpoints`` (pass-through, so
    compositions can hand ONE shared instance to every client).
    """

    def __init__(self, spec: Union[str, Sequence[str]], *,
                 client: str = "manager") -> None:
        if isinstance(spec, str):
            urls = [u.strip() for u in spec.split(",") if u.strip()]
        else:
            urls = [str(u).rstrip("/") for u in spec if u]
        self._ring = StickyFailover([u.rstrip("/") for u in urls])
        self.client = client

    @classmethod
    def of(
        cls, spec: "Union[str, Sequence[str], ManagerEndpoints]", *,
        client: str = "manager",
    ) -> "ManagerEndpoints":
        if isinstance(spec, ManagerEndpoints):
            return spec
        return cls(spec, client=client)

    def current(self) -> str:
        return self._ring.current()

    def all(self) -> List[str]:
        return self._ring.all()

    def __len__(self) -> int:
        return len(self._ring)

    def failover(self, seen: str) -> str:
        """Rotate past a failed endpoint (idempotent under races) and
        account it on the failover counter."""
        from .metrics import MANAGER_ENDPOINT_FAILOVERS_TOTAL

        MANAGER_ENDPOINT_FAILOVERS_TOTAL.inc(client=self.client)
        return self._ring.advance(seen)

    # Failures that mean "try the next replica": transport errors, plus
    # HTTP 503 — a standby manager refusing writes until promotion.
    @staticmethod
    def _fails_over(exc: BaseException) -> bool:
        if isinstance(exc, urllib.error.HTTPError):
            return exc.code == 503
        return isinstance(exc, (ConnectionError, TimeoutError, OSError))

    def call(self, fn: Callable[[str], T]) -> T:
        """Run ``fn(base_url)`` against the current endpoint, failing
        over through the full list once; the endpoint that answers
        stays current for every sharer of this instance.  Re-raises the
        last error after a full fruitless cycle."""
        last: Optional[BaseException] = None
        url = self.current()
        for _ in range(len(self._ring)):
            try:
                return fn(url)
            except Exception as exc:  # noqa: BLE001 — classified below
                if not self._fails_over(exc):
                    raise
                last = exc
                url = self.failover(url)
        assert last is not None
        raise last
