"""Minimal finite-state machine (reference dependency: looplab/fsm).

The scheduler's Peer/Task/Host resources gate every lifecycle transition
through an FSM (scheduler/resource/peer.go:52-110, task.go:57-85) so that
races between streams can't produce illegal states.  This is the same
event/transition model: named events, each with a set of legal source
states and one destination state, plus optional callbacks.

Thread-safe: transitions take a lock; an illegal event raises
InvalidEventError rather than silently corrupting state.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple


class FSMError(Exception):
    pass


class InvalidEventError(FSMError):
    def __init__(self, event: str, state: str):
        super().__init__(f"event {event!r} inappropriate in current state {state!r}")
        self.event = event
        self.state = state


@dataclass(frozen=True)
class EventDesc:
    name: str
    src: Sequence[str]
    dst: str


class FSM:
    def __init__(
        self,
        initial: str,
        events: Iterable[EventDesc],
        callbacks: Optional[Dict[str, Callable[["FSM", str, str, str], None]]] = None,
    ) -> None:
        """callbacks keys: ``enter_<state>``, ``after_<event>``, or ``enter_state``."""
        self._mu = threading.RLock()
        self._state = initial
        self._transitions: Dict[Tuple[str, str], str] = {}
        for e in events:
            for src in e.src:
                self._transitions[(e.name, src)] = e.dst
        self._callbacks = dict(callbacks or {})

    @property
    def current(self) -> str:
        with self._mu:
            return self._state

    def is_(self, state: str) -> bool:
        return self.current == state

    def can(self, event: str) -> bool:
        with self._mu:
            return (event, self._state) in self._transitions

    def event(self, name: str) -> None:
        with self._mu:
            key = (name, self._state)
            dst = self._transitions.get(key)
            if dst is None:
                raise InvalidEventError(name, self._state)
            src = self._state
            self._state = dst
            cbs = []
            for cb_key in (f"enter_{dst}", f"after_{name}", "enter_state"):
                cb = self._callbacks.get(cb_key)
                if cb is not None:
                    cbs.append(cb)
        for cb in cbs:
            cb(self, name, src, dst)

    def set_state(self, state: str) -> None:
        with self._mu:
            self._state = state
