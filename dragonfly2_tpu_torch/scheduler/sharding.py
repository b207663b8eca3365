"""Sharded scheduler fleet: the two steering exceptions.

Port of ``WrongShardError`` and ``ShardSaturatedError`` from
``dragonfly2_tpu/scheduler/sharding.py``, verbatim.  The wire maps them
to HTTP 421 and 503 + Retry-After (``rpc/scheduler_server.py``) and the
client raises them back (``rpc/scheduler_client.py``), so the port's
wire speaks the reference's steering answers.  The ring, the membership
directory, the shard guard and admission control are not ported
(ROADMAP queue 1 item 14): no port scheduler raises either exception,
and the scheduler binary refuses a sharded configuration.
"""

from __future__ import annotations


class WrongShardError(Exception):
    """REDIRECT-style steering answer: the task's swarm lives (or now
    lives) on another shard.  Carried over the wire as HTTP 421 with the
    owner's address so the client re-announces there instead of burning
    retries against a non-owner."""

    def __init__(
        self, task_id: str, *, owner_id: str = "", owner_url: str = "",
        ring_version: int = 0,
    ) -> None:
        super().__init__(
            f"task {task_id} is owned by shard {owner_id or '?'} "
            f"(ring v{ring_version})"
        )
        self.task_id = task_id
        self.owner_id = owner_id
        self.owner_url = owner_url
        self.ring_version = ring_version


class ShardSaturatedError(Exception):
    """Admission refusal: this shard is past its load bound and the
    request's priority class is in the shed band.  Carried over the wire
    as HTTP 503 + Retry-After (the §20 standby discipline): the client
    backs off instead of hammering a melting shard."""

    def __init__(self, *, retry_after_s: float = 1.0, reason: str = "") -> None:
        super().__init__(reason or "shard saturated")
        self.retry_after_s = retry_after_s
        self.reason = reason or "shard saturated"
