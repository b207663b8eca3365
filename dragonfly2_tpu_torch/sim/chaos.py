"""Chaos drill harness: scenario schedules + process-kill orchestration.

The reference proves compatibility and resilience with e2e drills
(test/e2e inside kind, Makefile:358-366) rather than policy text.  This
module is the equivalent for FAILURE: it packages the deterministic
fault-injection layer (utils/faultinject.py) into replayable scenarios
and gives tests the process plumbing to SIGKILL real service binaries
at controlled points.

Two ways to kill a process:

- ``ChaosProcess.sigkill()`` — the external kill, for "the box died"
  drills where the victim's position in its work doesn't matter;
- a ``crash`` FaultSpec in the scenario handed to the child via
  ``DF_FAULTINJECT`` — the child SIGKILLs ITSELF at an exact call index
  of an exact seam (e.g. ``trainer.dispatch`` #3), which makes
  "mid-upload"/"mid-ingest" deterministic instead of a sleep race.

Every drill's end state is digest-checked (``sha256_hex`` /
``task_digest``): surviving a fault with corrupt bytes is a FAILED
drill, whatever the status codes said.

Port of ``dragonfly2_tpu/sim/chaos.py``, verbatim but for
``ChaosProcess``'s default child environment: ``PYTHONPATH`` defaults to
the directory that holds this package (not the caller's working
directory), so ``python -m dragonfly2_tpu_torch.…`` resolves from any
directory, and no JAX setting is added.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.faultinject import ENV_VAR, FaultInjector, FaultSpec

# The directory that holds the package: a child's ``python -m`` finds
# ``dragonfly2_tpu_torch`` there.
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class ChaosScenario:
    """A named, seeded fault schedule — the replayable unit of chaos.

    ``injector()`` builds the in-process executor; ``env()`` serializes
    the schedule for a child process (installed by every CLI binary at
    boot via ``faultinject.install_from_env``).
    """

    seed: int = 0
    faults: List[FaultSpec] = field(default_factory=list)
    name: str = ""

    def injector(self, **kwargs) -> FaultInjector:
        return FaultInjector(list(self.faults), seed=self.seed, **kwargs)

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "name": self.name,
            "faults": [f.to_dict() for f in self.faults],
        })

    @classmethod
    def from_json(cls, data: str) -> "ChaosScenario":
        d = json.loads(data)
        return cls(
            seed=int(d.get("seed", 0)),
            name=d.get("name", ""),
            faults=[FaultSpec.from_dict(f) for f in d.get("faults", [])],
        )

    def env(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        out = dict(base if base is not None else os.environ)
        out[ENV_VAR] = self.to_json()
        return out


def drop_storm(
    seed: int, site: str = "rpc.client.*", probability: float = 0.2,
    **spec_kw,
) -> ChaosScenario:
    """Seed-derived random drops on a site family — the background-noise
    scenario soak runs layer under a workload."""
    return ChaosScenario(
        seed=seed, name=f"drop-storm:{site}",
        faults=[FaultSpec(site=site, kind="drop", probability=probability,
                          **spec_kw)],
    )


def crash_at(site: str, index: int, *, seed: int = 0) -> ChaosScenario:
    """SIGKILL the process at call `index` of `site` — the deterministic
    mid-flight kill used by the subprocess drills."""
    return ChaosScenario(
        seed=seed, name=f"crash:{site}#{index}",
        faults=[FaultSpec(site=site, kind="crash", at=(index,))],
    )


def replay_history(scenario: ChaosScenario, drive) -> List[tuple]:
    """Run ``drive(injector)`` under a fresh injector and return the
    injection history keys — calling this twice with the same scenario
    and the same drive MUST yield identical histories (the determinism
    contract tests assert)."""
    from ..utils import faultinject

    inj = scenario.injector()
    with faultinject.installed(inj):
        drive(inj)
    return inj.history_keys()


# ---------------------------------------------------------------------------
# Digest verification
# ---------------------------------------------------------------------------


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def task_digest(storage, task_id: str) -> str:
    """End-to-end digest of a completed task's assembled bytes (piece
    reads go through the store's crc verification)."""
    return sha256_hex(storage.read_task_bytes(task_id))


# ---------------------------------------------------------------------------
# Process orchestration
# ---------------------------------------------------------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ChaosProcess:
    """A service binary under drill control: spawn with an optional fault
    scenario in its environment, wait for ready lines on stdout, SIGKILL
    or await its (self-inflicted) death.

    ``ready_prefixes``: stdout line prefixes that must all appear before
    ``wait_ready`` returns; matched lines are kept (ports ride in them).
    """

    def __init__(
        self,
        argv: Sequence[str],
        *,
        scenario: Optional[ChaosScenario] = None,
        ready_prefixes: Sequence[str] = (),
        env: Optional[Dict[str, str]] = None,
        python: bool = True,
    ) -> None:
        self.argv = ([sys.executable, *argv] if python else list(argv))
        self.scenario = scenario
        self.ready_prefixes = tuple(ready_prefixes)
        base = dict(env if env is not None else os.environ)
        base.setdefault("PYTHONPATH", PACKAGE_PARENT)
        self.env = scenario.env(base) if scenario is not None else base
        self.proc: Optional[subprocess.Popen] = None
        self.lines: List[str] = []
        self.ready_lines: Dict[str, str] = {}
        self._ready = threading.Event()
        self._pump: Optional[threading.Thread] = None

    def start(self) -> "ChaosProcess":
        self.proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=self.env,
        )

        def pump() -> None:
            for line in self.proc.stdout:
                line = line.rstrip("\n")
                self.lines.append(line)
                for p in self.ready_prefixes:
                    if line.startswith(p):
                        self.ready_lines.setdefault(p, line)
                if len(self.ready_lines) == len(self.ready_prefixes):
                    self._ready.set()

        self._pump = threading.Thread(target=pump, daemon=True)
        self._pump.start()
        if not self.ready_prefixes:
            self._ready.set()
        return self

    def wait_ready(self, timeout: float = 60.0) -> Dict[str, str]:
        if not self._ready.wait(timeout):
            raise AssertionError(
                f"{self.argv}: never ready; last output: {self.lines[-12:]}"
            )
        return dict(self.ready_lines)

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def wait_dead(self, timeout: float = 60.0) -> int:
        """Await a self-inflicted (crash-fault) or natural exit; returns
        the return code (-9 for SIGKILL)."""
        return self.proc.wait(timeout=timeout)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def wait_until(fn, *, timeout: float = 30.0, interval: float = 0.05, desc=""):
    """Poll ``fn`` until truthy; raises AssertionError on timeout.  The
    drills' convergence helper (wait_for in deploy/e2e_loop.py, minus the
    SystemExit)."""
    deadline = time.monotonic() + timeout
    last: object = None
    while time.monotonic() < deadline:
        try:
            out = fn()
            if out:
                return out
            last = "falsy"
        except Exception as exc:  # noqa: BLE001 — converging system
            last = exc
        time.sleep(interval)
    raise AssertionError(f"chaos: timeout waiting for {desc or fn}: {last!r}")
