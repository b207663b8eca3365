"""Retry with bounded exponential backoff, full jitter, per-attempt
deadlines, and a circuit breaker (reference: pkg/retry + the rpc
clients' retry interceptors, pkg/rpc/interceptor.go).

Backoff is AWS-style FULL jitter: attempt i sleeps uniform(0,
min(base·2^i, max_delay)).  ``deadline_s`` bounds the WHOLE call
(attempts + sleeps); a callable that accepts a ``deadline_s`` kwarg
receives the remaining budget each attempt so the transport can clamp
its own timeout to what's left (deadline propagation) instead of
overshooting the caller's budget on the last attempt.

``CircuitBreaker`` guards a repeatedly-failing dependency (a dead
parent's piece port, an unreachable manager backend): after
``failure_threshold`` consecutive failures the circuit OPENS and calls
fail fast with ``CircuitOpenError`` (no connect timeout burned per
call) until ``reset_timeout_s`` passes, when ONE half-open probe is let
through — success closes the circuit, failure re-opens it.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


class RetryBudgetExceeded(TimeoutError):
    """The overall ``deadline_s`` expired before an attempt succeeded."""


class CircuitOpenError(ConnectionError):
    """Fast-fail: the breaker is OPEN for this dependency."""


class DecorrelatedJitterBackoff:
    """AWS-style decorrelated jitter: each delay is
    ``uniform(base, min(cap, prev * 3))`` — successive failures spread a
    fleet out instead of re-synchronizing it (the thundering-herd
    failure mode of fixed-interval retry loops after a manager bounce).

    ``rng`` is injectable, so a seeded ``random.Random`` makes the whole
    schedule reproducible per instance while staying decorrelated across
    a fleet seeded differently (the ModelSubscriber jitter discipline).
    ``reset()`` after a success returns the next failure to ``base``.
    """

    def __init__(
        self,
        *,
        base: float = 1.0,
        cap: float = 60.0,
        rng: Optional[random.Random] = None,
    ) -> None:
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap, got {base}/{cap}")
        self.base = base
        self.cap = cap
        self._rand = rng.uniform if rng is not None else random.uniform
        self._prev = base

    def next(self) -> float:
        delay = self._rand(self.base, min(self.cap, self._prev * 3.0))
        self._prev = delay
        return delay

    def reset(self) -> None:
        self._prev = self.base


# Gauge codes for rpc_circuit_breaker_state{target}.
_BREAKER_STATE_CODES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Consecutive-failure breaker with half-open recovery.

    States: ``closed`` (calls flow; failures count), ``open`` (calls
    fail fast until ``reset_timeout_s`` since the trip), ``half_open``
    (one probe in flight; its outcome decides).  Thread-safe; the clock
    is injectable so tests drive recovery without sleeping.

    With a ``name``, every state TRANSITION (never per-call) is exported
    on the ``rpc_circuit_breaker_state{target=...}`` gauge and logged
    once — a failover storm's open breakers are diagnosable from
    metrics/logs instead of invisible fast-fails.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self.name = name
        self._clock = clock
        self._mu = threading.Lock()
        self._failures = 0
        self._state = "closed"
        self._opened_at = 0.0
        if name:
            self._export("closed")

    def _export(self, state: str) -> None:
        from .metrics import CIRCUIT_BREAKER_STATE

        CIRCUIT_BREAKER_STATE.set(
            _BREAKER_STATE_CODES[state], target=self.name
        )

    def _note_transition(self, old: str, new: str) -> None:
        """OUTSIDE the lock: one gauge write + one log line per
        transition, not per call."""
        if old == new or not self.name:
            return
        import logging

        self._export(new)
        log = logging.getLogger(__name__)
        if new == "open":
            log.warning(
                "circuit breaker %s: %s -> open (failing fast for %.1fs)",
                self.name, old, self.reset_timeout_s,
            )
        else:
            log.info("circuit breaker %s: %s -> %s", self.name, old, new)

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now?  An allowed call while OPEN
        transitions to HALF_OPEN (that call is the recovery probe)."""
        with self._mu:
            old = self._state
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    self._state = "half_open"
                    out = True
                else:
                    out = False
            else:
                # half_open: one probe at a time — concurrent callers
                # wait out the probe as if still open.
                out = False
            new = self._state
        self._note_transition(old, new)
        return out

    def record_success(self) -> None:
        with self._mu:
            old = self._state
            self._failures = 0
            self._state = "closed"
        self._note_transition(old, "closed")

    def record_failure(self) -> None:
        with self._mu:
            old = self._state
            self._failures += 1
            if self._state == "half_open" or (
                self._failures >= self.failure_threshold
            ):
                self._state = "open"
                self._opened_at = self._clock()
            new = self._state
        self._note_transition(old, new)


def _accepts_deadline(fn) -> bool:
    """True when ``fn`` takes a ``deadline_s`` kwarg — inspected once and
    cached on the callable (source/client._accepts_headers pattern)."""
    try:
        cached = fn.__dict__.get("_df_accepts_deadline")
    except AttributeError:
        cached = None
    if cached is not None:
        return cached
    import inspect

    try:
        sig = inspect.signature(fn)
        ok = "deadline_s" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        )
    except (ValueError, TypeError):
        ok = False
    try:
        fn.__dict__["_df_accepts_deadline"] = ok
    except AttributeError:
        pass
    return ok


def retry_call(
    fn: Callable[..., T],
    *,
    attempts: int = 3,
    base_delay: float = 0.1,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (ConnectionError, TimeoutError, OSError),
    sleep: Callable[[float], None] = time.sleep,
    deadline_s: Optional[float] = None,
    breaker: Optional[CircuitBreaker] = None,
    rng: Optional[random.Random] = None,
    clock: Callable[[], float] = time.monotonic,
) -> T:
    """Call ``fn`` with bounded, fully-jittered exponential backoff.

    - ``deadline_s``: overall budget.  Attempts stop (RetryBudgetExceeded,
      chained to the last failure) once it's spent, and a deadline-aware
      ``fn`` receives the remaining budget via ``deadline_s=``.
    - ``breaker``: consulted before every attempt (CircuitOpenError when
      open) and told each outcome.
    - ``rng``: injectable jitter source — pass a seeded ``random.Random``
      for deterministic schedules (chaos drills replay exact timings).
    """
    rand = rng.uniform if rng is not None else random.uniform
    pass_deadline = deadline_s is not None and _accepts_deadline(fn)
    start = clock()
    last: BaseException | None = None
    for i in range(attempts):
        if deadline_s is not None:
            remaining = deadline_s - (clock() - start)
            if remaining <= 0:
                exc = RetryBudgetExceeded(
                    f"retry budget {deadline_s}s spent after {i} attempts"
                )
                if last is not None:
                    raise exc from last
                raise exc
        if breaker is not None and not breaker.allow():
            exc = CircuitOpenError("circuit open; failing fast")
            if last is not None:
                raise exc from last
            raise exc
        try:
            if pass_deadline:
                out = fn(deadline_s=max(deadline_s - (clock() - start), 0.0))
            else:
                out = fn()
        except retry_on as exc:  # noqa: PERF203
            if breaker is not None:
                breaker.record_failure()
            last = exc
            if i == attempts - 1:
                break
            delay = rand(0.0, min(base_delay * (2**i), max_delay))
            if deadline_s is not None:
                # Never sleep past the budget — the NEXT attempt should
                # get a chance (or the budget check should fire), not a
                # sleep that silently overshoots the caller's deadline.
                delay = min(delay, max(deadline_s - (clock() - start), 0.0))
            sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            return out
    assert last is not None
    raise last
