"""Interval-task garbage-collection runner (reference: pkg/gc/gc.go:28-137).

Services register named tasks with an interval and a timeout; a single
background scheduler ticks each task on its own cadence.  Used by the
scheduler to reap expired hosts/peers/tasks and by the daemon's storage
quota reclaimer.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict

logger = logging.getLogger(__name__)


@dataclass
class Task:
    id: str
    interval: float
    timeout: float
    runner: Callable[[], None]

    def __post_init__(self) -> None:
        if self.timeout > self.interval:
            raise ValueError(f"gc task {self.id}: timeout exceeds interval")
        if self.interval <= 0:
            raise ValueError(f"gc task {self.id}: non-positive interval")


class GC:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tasks: Dict[str, Task] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._started = False

    def add(self, task: Task) -> None:
        with self._mu:
            respawn = self._started and task.id not in self._threads
            self._tasks[task.id] = task
            # Re-adding an id only swaps the task object; the existing loop
            # thread reads the task from the registry each tick, so cadence
            # changes take effect without spawning a duplicate runner.
            if respawn:
                self._spawn(task.id)

    def run(self, task_id: str) -> None:
        """Run one task immediately (reference: gc.Run)."""
        with self._mu:
            task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(task_id)
        self._run_once(task)

    def run_all(self) -> None:
        with self._mu:
            tasks = list(self._tasks.values())
        for t in tasks:
            self._run_once(t)

    def _run_once(self, task: Task) -> None:
        done = threading.Event()

        def call() -> None:
            try:
                task.runner()
            except Exception:  # noqa: BLE001 — GC must never kill the service
                logger.exception("gc task %s failed", task.id)
            finally:
                done.set()

        t = threading.Thread(target=call, name=f"gc-run-{task.id}", daemon=True)
        t.start()
        if not done.wait(task.timeout):
            logger.warning("gc task %s timed out after %.1fs", task.id, task.timeout)

    def _spawn(self, task_id: str) -> None:
        def loop() -> None:
            while True:
                with self._mu:
                    task = self._tasks.get(task_id)
                if task is None:
                    return
                if self._stop.wait(task.interval):
                    return
                with self._mu:
                    task = self._tasks.get(task_id)
                if task is not None:
                    self._run_once(task)

        th = threading.Thread(target=loop, name=f"gc-{task_id}", daemon=True)
        th.start()
        self._threads[task_id] = th

    def start(self) -> None:
        with self._mu:
            if self._started:
                return
            self._started = True
            for task_id in self._tasks:
                self._spawn(task_id)

    def stop(self) -> None:
        self._stop.set()
